"""Tokenizers, normalizers, the scene pipeline, the synthetic scenes and the
token dataset: the port's own copies of umgen_tpu/data/{normalize,
tokenizers,pipeline,synthetic,dataset}.py (numpy and the standard library
only), each its counterpart with only the imports rewritten, like
umgen_tpu_torch/config.py and layout.py.  tests/test_torch_import.py holds
the copies to the JAX package's values."""

from umgen_tpu_torch.data.tokenizers import (
    BBox3DTokenizer,
    DigitalBinsTokenizer,
    TextTokenizer,
    default_bbox3d_tokenizer,
    default_ego_tokenizer,
)
from umgen_tpu_torch.data.normalize import MinMaxNormalizer, StandardNormalizer
from umgen_tpu_torch.data.pipeline import ScenePipeline

__all__ = [
    "BBox3DTokenizer",
    "DigitalBinsTokenizer",
    "TextTokenizer",
    "default_bbox3d_tokenizer",
    "default_ego_tokenizer",
    "MinMaxNormalizer",
    "StandardNormalizer",
    "ScenePipeline",
]
