"""One run of one cell: set-up, the measured window, the traced slice and
the reference's judgement, driven by the data files that BENCHMARK.json
names.

A cell names a configuration (benchmark/configs/<name>.json: the model's
sizes, the program's flags, how its weights are prepared, the window
semantics and storage formats the reference models, and the limits of the
compared numbers) and a traffic mix (benchmark/traffic/<name>.json, read by
benchmark/traffic/generator.py).  A per-layer metric is a reader,
benchmark/metrics/<name>.py, whose `read(t)` takes the traced run's data
and returns a number or None.

The frame loop makes the calls `Generator.generate` makes
(umgen_tpu_torch/models/generate.py:185-228): cached semantics ingest the
history in set-up (`Rollout.frame_step_chunked`, or `frame_step_prefill`)
and then run `frame_step_cached` frame after frame; recompute semantics run
`Rollout.frame_step` on the window's last frames.  A frame ends when its
tokens are on the host.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import trace as tr
from benchmark import work
from benchmark.traffic import generator as gen
from benchmark.weights import make_weights

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def seeds(seed: int) -> Dict[str, int]:
    """The run's independent streams, all from --seed."""
    names = ("weights", "sampling", "traffic")
    return {n: int(np.random.SeedSequence([seed, i]).generate_state(
        1, np.uint64)[0] >> 1) for i, n in enumerate(names)}


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_of(manifest: Dict, workload: str):
    """(cell, configuration entry) of `workload` in BENCHMARK.json."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    return cell, conf


def per_layer_of(manifest: Dict, cell: Dict) -> List[Dict]:
    """The per-layer metrics a traced run of `cell` reports."""
    e2e = {e["name"]: e for e in manifest["end_to_end"]}

    def reports(metric):
        w = metric.get("workloads")
        return cell["name"] in w if w is not None else True

    return [p for p in manifest["per_layer"]
            if reports(p) and p["moves"] in e2e and reports(e2e[p["moves"]])]


def reader(name: str, root: Path = BENCH_DIR) -> Callable:
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------
class Program:
    """The port, built from the configuration's flags on the benchmark's
    weights."""

    def __init__(self, conf: Dict, raw: Dict, device, extra_flags=()):
        from umgen_tpu_torch.models.rollout import Rollout
        from umgen_tpu_torch.models.umgen import UMGen
        from umgen_tpu_torch.runtime.quantize import (ALL_STACK_KEYS,
                                                      pack_fused_w4,
                                                      quantize_params_int8,
                                                      quantize_params_w4)
        from umgen_tpu_torch.tools import evaluate
        args = evaluate.build_parser().parse_args(
            list(conf["flags"]) + list(extra_flags)
            + ["--device", str(device)])
        evaluate.check_args(args)
        cfg = evaluate.config_from_args(args)
        # a control runs a lower-precision storage path on purpose
        check_sizes(conf, cfg, storage=not extra_flags)
        if conf["program_weights"] == "serving":
            # the JAX bench's serving weights (evaluate.serving_params):
            # int8 on every stack, W4A8 OAR packs from the raw OAR
            params = pack_fused_w4(quantize_params_int8(raw, ALL_STACK_KEYS),
                                   raw["oar"])
            if args.tar_w4:
                params = quantize_params_w4(params)
        elif conf["program_weights"] == "cli":
            params = evaluate.prepare_params(args, cfg, raw)
        else:
            raise ValueError(f"unknown program_weights "
                             f"{conf['program_weights']!r}")
        self.cfg = cfg
        self.model = UMGen(cfg)
        self.rollout = Rollout(self.model)
        self.params = params
        self.cache = None


def check_sizes(conf: Dict, cfg, storage: bool = True) -> None:
    """The program's configuration must be the one the file states (with
    `storage`, its rings' and OAR cache's formats too)."""
    m, ws = conf["model"], conf["window"]
    pairs = {k: getattr(cfg, k) for k in m if hasattr(cfg, k)}
    bad = {k: (m[k], v) for k, v in pairs.items() if m[k] != v}
    t_max = cfg.tar_cache_window or cfg.cond_frame
    mode = "recompute" if cfg.tar_mode == "recompute" else "cached"
    if mode != ws["mode"]:
        bad["mode"] = (ws["mode"], mode)
    if ws["window"] != (cfg.cond_frame if mode == "recompute" else t_max):
        bad["window"] = (ws["window"], t_max)
    if storage and mode == "cached" and ws["ring"] != {"int4": "int4"}.get(
            cfg.tar_cache_dtype, "none"):
        bad["ring"] = (ws["ring"], cfg.tar_cache_dtype)
    if storage and ws["oar_cache"] != {"int8": "int8"}.get(cfg.oar_cache_dtype, "none"):
        bad["oar_cache"] = (ws["oar_cache"], cfg.oar_cache_dtype)
    if bad:
        raise ValueError(f"configuration {conf['name']}: the program runs "
                         f"otherwise than the file states: {bad}")


def stored_mismatch(conf: Dict, raw: Dict, params: Dict) -> int:
    """Stacks named in the configuration's "stored_check" whose integer
    bytes in the program's weight tree differ from the format the
    configuration states for them: the reference's recipe (int8: a byte a
    linear weight, w4: half a byte), else the model's float type (none).
    It reads the tree the window is handed, not what a kernel does with
    it."""
    from benchmark.reference.model import LINEAR_NAMES
    per_weight = {"int8": 1.0, "w4": 0.5}
    stated = {key: kind for kind, keys in conf["reference_weights"]
              for key in keys}

    def tensors(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from tensors(v)
        elif isinstance(t, torch.Tensor):
            yield t

    def linear_numel(t, name):
        if isinstance(t, dict):
            if "w" in t and (name in LINEAR_NAMES or name.startswith("head_")):
                return t["w"].numel()
            return sum(linear_numel(v, k) for k, v in t.items())
        return 0

    bad = 0
    for key in conf["stored_check"]:
        if key not in raw:
            continue
        want = per_weight.get(stated.get(key), 0.0) * linear_numel(raw[key],
                                                                   key)
        got = sum(t.numel() * t.element_size()
                  for t in tensors(params.get(key, {}))
                  if not t.is_floating_point())
        bad += int(got != want)
    return bad


RING_FORMATS = {"bfloat16": torch.bfloat16}


def ring_mismatch(conf: Dict, cache: Dict) -> int:
    """Stacks named in the configuration's "ring_check" whose TAR rings, as
    the window leaves them in the program's cache, are not stored in the
    stated float format: a tensor of another type or fewer bytes a value
    (an fp8 or integer ring), no K or V at all, or K / V values on a grid
    coarser than the format's (over half of the nonzero bf16 values with
    their 4 lowest mantissa bits clear, as fp8 e4m3 values are; a sound
    bf16 ring has about 1 in 16 so).  It reads the state the window
    leaves, not what a kernel does with it."""
    spec = conf["ring_check"]
    want = RING_FORMATS[spec["format"]]
    bad = 0
    for name in spec["stacks"]:
        ring = (cache or {}).get(name)
        if not isinstance(ring, (tuple, list)) or len(ring) < 2 or any(
                not isinstance(t, torch.Tensor) or t.dtype != want
                for t in ring):
            bad += 1
            continue
        coarse, empty = False, True
        for t in ring[:2]:
            for layer_kv in t:                       # a layer at a time
                bits = layer_kv.contiguous().view(torch.int16)
                nonzero = (bits & 0x7FFF) != 0
                n = int(nonzero.sum())
                empty &= n == 0
                coarse |= n > 0 and int(
                    (((bits & 0xF) == 0) & nonzero).sum()) * 2 > n
        bad += int(coarse or empty)
    return bad


class Draws(dict):
    """One take of a `Recorder`: {modality: [tokens, ...]} in report order
    (every role), and `reports`, [(modality, role, content position,
    tokens)]."""

    def __init__(self, reports: List[Tuple]):
        super().__init__()
        for mod, _, _, tok in reports:
            self.setdefault(mod, []).append(tok)
        self.reports = reports


class Recorder:
    """The program's token draws, as it reports them through its public
    hook `Rollout.draw_hook` (modality, role, content position, tokens),
    in the order reported.  The device tensors are kept as they come: no
    synchronization inside the window.  The recorder stays under whatever
    hook is set on the rollout afterwards: each report reaches both."""

    def __init__(self, rollout):
        self.calls: List[Tuple] = []
        record = self.calls.append

        def chain(other):
            if other is None:
                return lambda *a: record(a)

            def both(*a):
                record(a)
                other(*a)
            return both

        def set_hook(ro, fn):
            ro.__dict__["_recorded_hook"] = chain(fn)

        rollout.__class__ = type(
            "Recorded" + type(rollout).__name__, (type(rollout),),
            {"draw_hook": property(lambda ro: ro.__dict__["_recorded_hook"],
                                   set_hook)})
        rollout.draw_hook = rollout.__dict__.pop("draw_hook", None)

    def take(self) -> Draws:
        out = Draws(self.calls[:])
        self.calls.clear()
        return out


# the draws the judge reads, by modality: (the hook's role, the judge's
# name).  A "served" segment [B, n] at its first content position, or the
# ego action [B, 3], stands for the first role of each position it covers;
# an agent position's "control" redraw is reported but not judged.
JUDGED_ROLES = {"pose": (("ego", "pose"),), "map": (("ar", "map"),),
                "image": (("ar", "image"),),
                "bbox3d": (("ar", "bbox_ar"), ("tar", "bbox_tar"))}


def content_positions(layout) -> Dict[str, range]:
    """Each modality's content positions in the program's frame sequence
    (the task token first, then each segment's <bos>, content, <eos>)."""
    out, pos = {}, 0
    for mod, n, _, _ in layout:
        out[mod] = range(pos + 2, pos + 2 + n)
        pos += n + 2
    return out


def frame_draws(calls: Draws, rows, layout) -> Dict:
    """One frame's draws of scenes `rows` → {pose [k, 3], map, bbox_ar,
    bbox_tar, image [k, n]}, from a `Recorder`'s take of the reports of
    `Rollout.draw_hook`.  Every content position must have exactly one
    draw of each role the judge reads there: a program that reports
    otherwise fails here by name, not as a wrong token."""
    at: Dict[Tuple, List] = {}
    for mod, role, pos, tok in calls.reports:
        if role == "control" or mod not in JUDGED_ROLES:
            continue
        if role in ("served", "ego"):
            role = JUDGED_ROLES[mod][0][0]
        cols = tok.shape[1] if tok.dim() == 2 else None
        for c in range(cols or 1):
            at.setdefault((mod, role, pos + c), []).append(
                tok[:, c] if cols else tok)
    out = {}
    for mod, places in content_positions(layout).items():
        for role, name in JUDGED_ROLES[mod]:
            got = [at.get((mod, role, p), ()) for p in places]
            bad = [p for p, g in zip(places, got) if len(g) != 1]
            if bad:
                n = len(got[places.index(bad[0])])
                raise RuntimeError(
                    f"Rollout.draw_hook reported {n} {role!r} draws of "
                    f"{mod!r} at content position {bad[0]} ({len(bad)} of "
                    f"the frame's {len(places)} positions without exactly "
                    f"one): the benchmark judges one draw a position, "
                    f"reported once a position or once a segment (role "
                    f"'served')")
            out[name] = torch.stack([g[0] for g in got], 1)[rows] \
                .cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT, t_start: float = None,
             extra_flags=(), patch: Optional[Callable] = None,
             control_act: Optional[str] = None, log=print) -> Dict:
    """Run `workload` once → the result line's object (without the JSON).
    `extra_flags`: added to the configuration's flags (the control's
    lower-precision path); `control_act`: the reference in that activation
    precision judged in the program's place (the control where the program
    has no such path); `patch(program)`: applied before set-up (the fault
    tests).  None is used by the benchmark's own runs."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_json(root / "BENCHMARK.json")
    cell, entry = cell_of(manifest, workload)
    conf = load_json(root / entry["file"])
    conf["name"] = entry["name"]
    mix = gen.load_mix(cell["traffic"], root / "benchmark" / "traffic")
    m, ws = conf["model"], conf["window"]
    sd = seeds(seed)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:                       # the peak of this run alone
        torch.empty(0, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tracer = None
    if trace and cuda:
        # the program's own tracer over set-up (its device-timed spans)
        from umgen_tpu_torch.runtime import profiler as tracer
        tracer.start(dev)

    raw = make_weights(m, sd["weights"], dev)
    prog = Program(conf, raw, dev, extra_flags)
    stored = stored_mismatch(conf, raw, prog.params)
    del raw
    if patch is not None:
        patch(prog)
    rec = Recorder(prog.rollout)
    spans = tr.Spans()
    if trace and cuda:
        cached = ws["mode"] == "cached"
        spans.wrap(prog.model, "ego_logits_cached" if cached else "ego_logits",
                   "ego")
        spans.wrap(prog.model, "tar_priors_cached" if cached else "tar_priors",
                   "tar")
        spans.wrap(prog.rollout, "_finish_frame", "oar")

    B = mix["scenes"]
    hist = gen.history_tokens(m, B, mix["history_frames"], sd["traffic"])
    stream = {k: v.astype(np.int64) for k, v in hist.items()}
    mods = [s[0] for s in m["layout"]]
    content, pos = {}, 0
    for mod, n, _, _ in m["layout"]:
        content[mod] = slice(pos + 1, pos + 1 + n)     # 0-based stream index
        pos += n + 2
    g = torch.Generator(device=dev)
    g.manual_seed(sd["sampling"])
    rows = gen.check_scene_ids(B, mix["check_scenes"], seed)
    cfg, ro, params = prog.cfg, prog.rollout, prog.params

    def to_dev(frames):
        return {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                for k, v in frames.items()}

    def step(first: bool):
        if ws["mode"] == "recompute":
            res = ro.frame_step(params, to_dev(
                {k: v[:, -ws["window"]:] for k, v in stream.items()}), g)
        elif first:
            entry_fn = ro.frame_step_chunked if cfg.chunked_prefill and \
                stream["pose"].shape[1] > 1 else ro.frame_step_prefill
            res, prog.cache = entry_fn(params, to_dev(stream), g)
        else:
            res, prog.cache = ro.frame_step_cached(
                params, to_dev({k: v[:, -1:] for k, v in stream.items()}),
                prog.cache, g)
        tokens = res.tokens.cpu().numpy()
        finite = torch.isfinite(res.prior_seq).flatten(1).all(1)
        if res.ego_logits is not None:
            finite &= torch.isfinite(res.ego_logits).flatten(1).all(1)
        for k in mods:
            stream[k] = np.concatenate(
                [stream[k], tokens[:, None, content[k]]], axis=1)
        return res, tokens, finite

    for i in range(mix["warm_frames"]):
        step(first=i == 0)
    if cuda:
        torch.cuda.synchronize()
    rec.take()
    # the window runs without the program's tracer
    setup_rec = tracer.stop() if tracer is not None else None
    spans.on = bool(trace and cuda)

    # ---- the measured window ------------------------------------------
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    judged, failed, n_frames, frame_s = [], 0, 0, []
    t_end = t0
    first_timed = stream["pose"].shape[1]
    while time.perf_counter() < deadline:
        t_frame = time.perf_counter()
        res, tokens, finite = step(first=False)
        t_end = time.perf_counter()
        frame_s.append(t_end - t_frame)
        vocab = np.array([m["pose_vocab_size"], m["map_vocab_size"],
                          m["bbox3d_vocab_size"], m["img_vocab_size"]])
        bad = ~finite.cpu().numpy()
        for i, k in enumerate(mods):
            c = tokens[:, content[k]]
            bad |= ((c < 0) | (c >= vocab[i])).any(1)
        failed += int(bad.sum())
        n_frames += 1
        # the judged scenes' outputs wait on the host, out of the
        # program's device memory
        judged.append({"served": tokens[rows], "draws": rec.take(),
                       "prior": res.prior_seq[rows].cpu(),
                       "ego": res.ego_logits[rows].cpu()})
        del res
    window_s = t_end - t0
    spans.on = False
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    rings = (ring_mismatch(conf, prog.cache) if "ring_check" in conf
             else None)
    for jf in judged:
        jf["draws"] = frame_draws(jf["draws"], rows, m["layout"])

    out = {"correct": None, "attempted": B * n_frames, "failed": failed}
    e2e = {"frames_per_s": B * n_frames / window_s,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    units = {e["name"]: e["unit"] for e in manifest["end_to_end"]}
    metrics = {}
    if trace and cuda:
        data = traced(prog, spans, step, n_frames, window_s, B, conf, m, ws,
                      tracer, dev)
        data["setup"] = setup_rec
        for p in per_layer_of(manifest, cell):
            v = reader(p["name"], root / "benchmark")(data)
            if v is not None:
                metrics[p["name"]] = {"value": v, "unit": p["unit"]}
        out["breakdown"] = tr.breakdown(data["sessions"])
    elif not trace:
        metrics = {n: {"value": v, "unit": units[n]} for n, v in e2e.items()
                   if n in units}
    log(f"run: {workload} seed {seed}: {n_frames} frames of {B} scenes in "
        f"{window_s:.3f} s, set-up {setup_s:.3f} s; frames "
        f"{[round(t, 3) for t in frame_s]} s")

    # ---- the reference's judgement --------------------------------------
    del prog, params, ro, spans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = judge(conf, m, ws, sd, dev, stream, judged, rows, first_timed,
                    control_act)
    numbers["stored_mismatch"] = stored
    if rings is not None:
        numbers["ring_mismatch"] = rings
    log(f"check: {len(judged)} frames of {len(rows)} scenes judged in "
        f"{time.perf_counter() - t_check:.3f} s")
    limits = conf["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    out["correct"] = bool(n_frames > 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    out["metrics"] = metrics
    out["device"] = device_info(dev, peak)
    if trace and cuda:
        out["device"]["busy_s"] = sum(s["busy_s"] for s in data["sessions"])
        out["device"]["window_s"] = sum(s["window_s"]
                                        for s in data["sessions"])
    out["checks"] = checks
    return out


def judge(conf, m, ws, sd, dev, stream, judged, rows, first_timed,
          control_act=None):
    """The reference replays each judged scene: the history, then every
    frame the program served, judging the timed ones.  `control_act`: the
    reference in lower-precision activations stands in the program's
    place (the configuration's control where the program has no path of
    its own)."""
    from benchmark.reference import check as chk
    from benchmark.reference.model import Reference, prepare_weights
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        raw = make_weights(m, sd["weights"], dev)
        w = prepare_weights(raw, conf["reference_weights"])
        del raw
        ref = Reference(m, w, ws["ring"], ws["oar_cache"])
        ctl = None if control_act is None else Reference(
            m, w, ws["ring"], ws["oar_cache"], act=control_act)
        j = chk.Judge()
        mods = [s[0] for s in m["layout"]]
        with torch.no_grad():
            for r_i, b in enumerate(rows):
                n = stream["pose"].shape[1]
                frames = [{k: stream[k][b, t] for k in mods}
                          for t in range(n)]
                got = {first_timed + f: {k: (v[r_i] if k != "draws" else
                                             {d: x[r_i]
                                              for d, x in v.items()})
                                         for k, v in jf.items()}
                       for f, jf in enumerate(judged)}
                chk.judge_scene(ref, frames, got, ws["mode"], ws["window"],
                                j, dev, ctl)
        return j.numbers()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]


def device_info(dev, peak: int) -> Dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak),
            "power_limit": limit}


# ---------------------------------------------------------------------------
# the traced run's extra frame
# ---------------------------------------------------------------------------
DECODE_SLICE = (925, 1125)     # OAR calls of the frame the profiler sees


def traced(prog, spans, step, n_frames, window_s, B, conf, m, ws, tracer,
           dev) -> Dict:
    """The spans of the window's frames, then one more frame whose cascade
    and a slice of whose decode steps run under torch.profiler, with the
    program's tracer on: its spans' `record_function` ranges tag the
    profiled operations, and its records of the frame (host spans, decode
    steps counted by kernel) are kept."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from umgen_tpu_torch.ops import attention as attn_mod
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ms = spans.ms()
    state = {"calls": 0, "prof": None, "ctx": None, "oar": [], "flash": []}
    profs = {}

    def begin(name):
        state["prof"] = profile(activities=acts)
        state["prof"].start()
        state["ctx"] = record_function(name)
        state["ctx"].__enter__()

    def end(name):
        state["ctx"].__exit__(None, None, None)
        torch.cuda.synchronize()
        state["prof"].stop()
        profs[name] = state["prof"]
        state["prof"] = state["ctx"] = None

    flash = attn_mod.flash_attention

    def flash_traced(q, k, v, causal):
        if state["prof"] is None:
            return flash(q, k, v, causal)
        state["flash"].append((q.shape[0], q.shape[1], k.shape[1], causal,
                               q.shape[2], q.shape[3]))
        with record_function("bench.flash"):
            return flash(q, k, v, causal)

    finish, oar_step = prog.rollout._finish_frame, prog.rollout.oar_step

    def finish_traced(*a, **k):
        if state["prof"] is not None:
            end("bench.cascade")
        return finish(*a, **k)

    def oar_traced(params, x, kv_k, kv_v, cache_len):
        i = state["calls"]
        state["calls"] += 1
        if i == DECODE_SLICE[0]:
            begin("bench.decode")
        if i == DECODE_SLICE[1] and state["prof"] is not None:
            end("bench.decode")
        if state["prof"] is None:
            return oar_step(params, x, kv_k, kv_v, cache_len)
        state["oar"].append((x.shape[0], x.shape[1], cache_len))
        with record_function("bench.oar_step"):
            return oar_step(params, x, kv_k, kv_v, cache_len)

    attn_mod.flash_attention = flash_traced
    prog.rollout._finish_frame = finish_traced
    prog.rollout.oar_step = oar_traced
    tracer.start(dev)
    try:
        torch.cuda.synchronize()
        begin("bench.cascade")
        step(first=False)
        if state["prof"] is not None:
            end("bench.decode")
    finally:
        attn_mod.flash_attention = flash
        program = tracer.stop()
    by_name = {n: tr.reduce_session(p, n) for n, p in profs.items()}
    segs = {mod: n for mod, n, _, _ in m["layout"]}
    return {"frames": n_frames, "scenes": B, "window_s": window_s,
            "spans_ms": ms,
            "sessions": [s for s in by_name.values() if s is not None],
            "cascade": by_name.get("bench.cascade"),
            "decode": by_name.get("bench.decode"),
            "oar_calls": state["oar"], "flash_calls": state["flash"],
            "decode_steps": DECODE_SLICE[1] - DECODE_SLICE[0],
            "decode_calls": state["calls"],
            "decode_work": conf["decode_work"], "model": m,
            "program": program,
            "frame_flops": work.frame_flops(m, segs, ws["mode"],
                                            ws["window"])}
