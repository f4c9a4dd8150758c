"""The whole frame step's share of the card's bf16 peak, %: the model FLOPs
of the traced window's scene-frames (benchmark/work.py `frame_flops`, from
the layer equations) over the window's seconds × 989 TFLOP/s."""

from benchmark import work


def read(t):
    if not t["frames"] or t["window_s"] <= 0:
        return None
    flops = t["frames"] * t["scenes"] * t["frame_flops"]
    return 100.0 * flops / (t["window_s"] * work.H100_BF16_FLOPS)
