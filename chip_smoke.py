#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mlagg_unet_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``) and
``nvidia-smi``; it imports neither JAX nor the JAX package. Phases, any
failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: nvcc builds every kernel of the serving path from ``csrc/``
   into ``mlagg_unet_torch/_build/``;
3. kernels: each kernel against its plain PyTorch twin at the flagship's
   shapes (model batch 16, tile 256x224), fp32 and bf16 I/O, with the
   tolerances stated below, and timed with CUDA events (median of 20);
4. model: the full-width flagship (``bench.py``'s config, seeded random
   weights) on one tile, fp32 on the card (kernels) against the CPU (plain
   twins); then a bf16 forward at model batch 16;
5. serve: ``VolumePredictor`` on ``bench.py``'s workload (8 volumes of
   1x10x320x260, mirror TTA over both in-plane axes, bf16), volumes/s and
   peak memory; every kernel's launch count must grow in this phase;
6. a ``{"kernels": [...]}`` line, then the card's ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Kernel times in the JSON line are per flagship forward at model batch 16:
the sum over the launches one forward makes (K1 2, K2 8, K3 8, K4 16).
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense bf16 tensor core; fp32 FMA

BM = 16                                  # model batch: 4 tiles x 4 mirrors
TILE = (256, 224)
STAGE_C = (96, 192, 384, 768)
STAGE_N = (14336, 3584, 896, 224)        # tokens per tile at each stage
POOL_HEADS = (1, 2, 4, 8)                # differential heads of the pooled half
HEAD_DIM, POOL_LK = 24, 56
SCAN_D, SCAN_N, SCAN_L = 96, 16, sum(STAGE_N)
DEPTH = 2                                # blocks per stage

# tolerances, relative to the reference output's max |value|
TOL_FP32 = 1e-4    # fp32 I/O: only the order of fp32 sums differs
TOL_BF16 = 2e-2    # bf16 I/O: one bf16 rounding of the output and of the
                   # plain twin's intermediates
TOL_SCAN = 1e-4    # the scan's output is fp32 for either input type
TOL_MODEL = 1e-3   # fp32 flagship card vs CPU: ~40 layers of re-ordered fp32
                   # sums, __expf in the scan, renormalised by LN/GroupNorm
TOL_SERVE_REL_L2 = 5e-2  # bf16 serving vs fp32 serving of one volume


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median over ``reps`` of one call's CUDA-event time."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|)."""
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Report:
    """Per-kernel numbers of one run, summed per flagship forward."""

    def __init__(self):
        self.rows = {}

    def add(self, name, source, replaces, kind="bf16", **vals):
        row = self.rows.setdefault(name, dict(
            name=name, route="cuda", source=source, replaces=replaces, kind=kind,
            launches=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            bytes=0.0, flops=0.0, library_ms=None))
        for k, v in vals.items():
            if k == "max_abs_err":
                row[k] = max(row[k], v)
            elif k == "library_ms":
                row[k] = (row[k] or 0.0) + v
            else:
                row[k] += v

    def finish(self, launches):
        out = []
        for row in self.rows.values():
            t, by = bound_ms(row.pop("bytes"), row.pop("flops"), row.pop("kind"))
            row.update(bound_ms=t, bound_by=by, launches=launches[row["name"]])
            out.append(row)
        return out


def check(label, got, ref, tol) -> float:
    d, r = rel_err(got, ref)
    log(f"  {label}: max_abs_err {d:.3e}  rel {r:.3e}  (tol {tol:g})")
    if not math.isfinite(r) or r > tol:
        fail(f"{label}: relative error {r:.3e} > {tol:g}")
    return d


def phase_kernels(torch, report: Report) -> None:
    from mlagg_unet_torch.ops.flash_attention import attention_reference, flash_attention
    from mlagg_unet_torch.ops.mlla_fused import (
        mlla_front, mlla_front_plain, mlla_tail, mlla_tail_plain)
    from mlagg_unet_torch.ops.selective_scan import selective_scan_seq_ref
    from mlagg_unet_torch.ops.selective_scan_cuda import scan_fwd_plain, selective_scan_fwd

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)

    def T(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    # ---- K1 selective scan forward: (16, 2, 96, 19040), both directions
    log("[kernels] K1 selective_scan_fwd")
    b, g, d, n, L = BM, 2, SCAN_D, SCAN_N, SCAN_L
    A = T(-np.tile(np.arange(1, n + 1, dtype=np.float32), (g, d, 1)))
    dt0 = np.exp(rs.rand(g, d) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    bias = T(dt0 + np.log(-np.expm1(-dt0)))
    Dp = T(1 + 0.1 * rs.randn(g, d))
    full = [T(rs.randn(b, g, d, L) * s) for s in (1.0, 0.5)] + \
           [T(rs.randn(b, g, n, L)) for _ in range(2)]
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        u, dl, Bm, Cm = (t.to(dtype) for t in full)
        for rev in (False, True):
            args = (u, dl, A, Bm, Cm, Dp, bias, True, rev)
            err = check(f"K1 {tag} reverse={rev} vs plain chunked",
                        selective_scan_fwd(*args), scan_fwd_plain(*args), TOL_SCAN)
            if tag == "bf16":
                ms = time_ms(lambda: selective_scan_fwd(*args))
                pms = time_ms(lambda: scan_fwd_plain(*args), reps=5, warmup=1)
                el = b * g * d * L
                nbytes = 2 * el * 2 + 2 * b * g * n * L * 2 + el * 4
                flops = el * (6 * n + 7)
                log(f"  K1 bf16 reverse={rev}: {ms:.3f} ms, plain {pms:.3f} ms")
                # elementwise recurrence: no tensor-core form, fp32 rate
                report.add("selective_scan_fwd", "mlagg_unet_torch/csrc/selective_scan_fwd.cu",
                           "mlagg_unet_tpu/ops/selective_scan_pallas.py:172", kind="fp32",
                           max_abs_err=err, ms=ms, plain_ms=pms,
                           bytes=nbytes, flops=flops)
    short = [t[:2, ..., :1024].contiguous() for t in full]
    for rev in (False, True):
        args = (*short[:2], A, *short[2:], Dp, bias, True, rev)
        check(f"K1 fp32 reverse={rev} vs step reference (L=1024)",
              selective_scan_fwd(*args),
              selective_scan_seq_ref(*args[:8], reverse=rev), TOL_SCAN)
    del full, short

    # ---- K2 / K3 MLLA front / tail at every stage, 2 blocks per stage
    for C, N in zip(STAGE_C, STAGE_N):
        M, Hd = BM * N, 2 * C
        log(f"[kernels] K2/K3 mlla front/tail C={C} tokens={M}")
        wsc = 1 / math.sqrt(C)
        raw = dict(x=rs.randn(M, C), lw=1 + 0.1 * rs.randn(C), lb=0.1 * rs.randn(C),
                   wa=rs.randn(C, C) * wsc, ba=0.1 * rs.randn(C),
                   wi=rs.randn(C, C) * wsc, bi=0.1 * rs.randn(C),
                   h=rs.randn(M, C), a=rs.randn(M, C), s=rs.randn(M, C),
                   wo=rs.randn(C, C) * wsc, bo=0.1 * rs.randn(C),
                   w1=rs.randn(Hd, C) * wsc, b1=0.1 * rs.randn(Hd),
                   w2=rs.randn(C, Hd) / math.sqrt(Hd), b2=0.1 * rs.randn(C))
        for dtype, tag, tol in ((torch.float32, "fp32", TOL_FP32),
                                (torch.bfloat16, "bf16", TOL_BF16)):
            t = {k: T(v, dtype) for k, v in raw.items()}
            fa = (t["x"], t["lw"], t["lb"], t["wa"], t["ba"], t["wi"], t["bi"])
            ta = (t["h"], t["a"], t["s"], t["wo"], t["bo"], t["lw"], t["lb"],
                  t["w1"], t["b1"], t["w2"], t["b2"])
            got, ref = mlla_front(*fa), mlla_front_plain(*fa)
            e_f = max(check(f"K2 {tag} C={C} a", got[0], ref[0], tol),
                      check(f"K2 {tag} C={C} h", got[1], ref[1], tol))
            e_t = check(f"K3 {tag} C={C}", mlla_tail(*ta), mlla_tail_plain(*ta), tol)
            if tag != "bf16":
                continue
            isz = 2
            for name, fn, pfn, args, err, nbytes, flops, rep in (
                    ("mlla_front", mlla_front, mlla_front_plain, fa, e_f,
                     (3 * M * C + 2 * C * C + 6 * C) * isz, 4 * M * C * C,
                     "mlagg_unet_tpu/ops/mlla_fused.py:76"),
                    ("mlla_tail", mlla_tail, mlla_tail_plain, ta, e_t,
                     (4 * M * C + C * C + 2 * C * Hd + 5 * C + Hd) * isz,
                     2 * M * C * C + 4 * M * C * Hd,
                     "mlagg_unet_tpu/ops/mlla_fused.py:48")):
                ms = time_ms(lambda: fn(*args))
                pms = time_ms(lambda: pfn(*args))
                log(f"  {name} bf16 C={C}: {ms:.3f} ms, plain {pms:.3f} ms (x{DEPTH} per forward)")
                report.add(name, "mlagg_unet_torch/csrc/mlla_fused.cu", rep,
                           max_abs_err=err, ms=DEPTH * ms, plain_ms=DEPTH * pms,
                           bytes=DEPTH * nbytes, flops=DEPTH * flops)
        del raw, t

    # ---- K4 attention on the pooled branch: 2 calls per block
    for C, N, nh in zip(STAGE_C, STAGE_N, POOL_HEADS):
        hd, P = HEAD_DIM, POOL_LK
        scale = hd ** -0.5
        log(f"[kernels] K4 flash_attn_fwd q=({BM},{nh},{N},{hd}) k=({P},{hd}) v=({P},{2 * hd})")
        rq = rs.randn(BM, N, nh, 2, hd) * scale
        rk = rs.randn(BM, P, nh, 2, hd)
        rv = rs.randn(BM, P, nh, 2 * hd)
        for dtype, tag, tol in ((torch.float32, "fp32", TOL_FP32),
                                (torch.bfloat16, "bf16", TOL_BF16)):
            # the strided head views the model hands the kernel
            q = T(rq, dtype)[:, :, :, 0].transpose(1, 2)
            k = T(rk, dtype)[:, :, :, 0].transpose(1, 2)
            v = T(rv, dtype).transpose(1, 2)
            err = check(f"K4 {tag} nh={nh}", flash_attention(q, k, v, scale),
                        attention_reference(q, k, v, scale), tol)
            if tag != "bf16":
                continue
            calls = 2 * DEPTH
            ms = time_ms(lambda: flash_attention(q, k, v, scale))
            pms = time_ms(lambda: attention_reference(q, k, v, scale))
            lms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale))
            log(f"  K4 bf16 nh={nh}: {ms:.3f} ms, plain {pms:.3f} ms, sdpa {lms:.3f} ms (x{calls} per forward)")
            nbytes = (q.numel() + k.numel() + v.numel() + BM * nh * N * 2 * hd) * 2
            flops = 2 * BM * nh * N * P * (hd + 2 * hd)
            report.add("flash_attn_fwd", "mlagg_unet_torch/csrc/flash_attn_fwd.cu",
                       "mlagg_unet_tpu/ops/flash_attention.py:64",
                       max_abs_err=err, ms=calls * ms, plain_ms=calls * pms,
                       library_ms=calls * lms, bytes=calls * nbytes,
                       flops=calls * flops)


def phase_model(torch):
    from mlagg_unet_torch import build_flagship

    log("[model] full-width flagship, one 256x224 tile, fp32 card vs CPU")
    model = build_flagship(num_classes=4, seed=0, device="cuda")
    nparams = sum(p.numel() for p in model.parameters())
    log(f"  params: {nparams}")
    x = np.random.RandomState(0).randn(1, *TILE, 1).astype(np.float32)
    with torch.inference_mode():
        gpu = model(torch.from_numpy(x).cuda())
        t0 = time.perf_counter()
        cpu = copy.deepcopy(model).cpu()(torch.from_numpy(x))
        log(f"  CPU forward: {time.perf_counter() - t0:.1f} s")
    if len(gpu) != 5:
        fail(f"expected 5 outputs, got {len(gpu)}")
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        if g.shape != c.shape or not torch.isfinite(g).all():
            fail(f"output {i}: shape {tuple(g.shape)} vs {tuple(c.shape)} or not finite")
        check(f"output {i} {tuple(g.shape)}", g.cpu(), c, TOL_MODEL)
    with torch.inference_mode():
        xb = torch.from_numpy(np.random.RandomState(1).rand(BM, *TILE, 1)
                              .astype(np.float32)).cuda().bfloat16()
        model16 = copy.deepcopy(model).bfloat16()
        outs = model16(xb)
        torch.cuda.synchronize()
        for i, o in enumerate(outs):
            if o.dtype != torch.bfloat16 or not torch.isfinite(o).all():
                fail(f"bf16 batch-{BM} output {i}: {o.dtype}, "
                     f"finite={bool(torch.isfinite(o).all())}")
        fwd_ms = time_ms(lambda: model16(xb), reps=5, warmup=1)
    log(f"  bf16 forward at model batch {BM}: 5 finite outputs, out0 "
        f"{tuple(outs[0].shape)}, {fwd_ms:.2f} ms (median of 5)")
    return model


def profile_volume(torch, pred, volume) -> None:
    """Device time by kernel over one served volume, the port's kernels
    against the rest, and the device's busy share of the wall time
    (torch.profiler, whose own host overhead is in the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred(volume)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not dev:
        log("  profile: no device time recorded (not measured)")
        return
    busy_ms = sum(t for _, t, _ in dev)
    ours = sum(t for k, t, _ in dev if any(
        n in k for n in ("scan_fwd_kernel", "front_kernel", "tail_kernel", "flash_fwd_kernel")))
    log(f"  profile of one volume: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(c for *_, c in dev)} device ops; "
        f"port kernels {ours:.1f} ms ({100 * ours / busy_ms:.1f}% of busy)")
    for key, t, count in sorted(dev, key=lambda r: -r[1])[:15]:
        log(f"    {t:9.2f} ms {100 * t / busy_ms:5.1f}% x{count:<5d} {key[:100]}")


def phase_serve(torch, model):
    from mlagg_unet_torch import VolumePredictor
    from mlagg_unet_torch.ops import _ext

    log("[serve] VolumePredictor, 8 volumes of 1x10x320x260, mirror (0, 1), bf16")
    rng = np.random.RandomState(0)
    volumes = [rng.rand(1, 10, 320, 260).astype(np.float32) for _ in range(8)]
    pred = VolumePredictor(model, TILE, 4, mirror_axes=(0, 1), tile_batch_size=4,
                           compute_dtype=torch.bfloat16, device="cuda")
    ref32 = VolumePredictor(model, TILE, 4, mirror_axes=(0, 1), tile_batch_size=4,
                            device="cuda")(volumes[0])
    first = pred(volumes[0])                     # warm-up
    d = np.linalg.norm(first - ref32) / np.linalg.norm(ref32)
    log(f"  bf16 vs fp32 serving of volume 0: rel L2 {d:.3e} (tol {TOL_SERVE_REL_L2:g})")
    if not d <= TOL_SERVE_REL_L2:
        fail(f"bf16 serving disagrees with fp32 serving: rel L2 {d:.3e}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    pending = [pred.predict_device(v) for v in volumes]
    outs = [pred.finalize(p) for p in pending]
    elapsed = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _ext.ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for o in outs:
        if o.shape != (4, 10, 320, 260) or not np.isfinite(o).all():
            fail(f"serve output {o.shape}, finite={bool(np.isfinite(o).all())}")
    vps = len(volumes) / elapsed
    log(f"  {vps:.4f} volumes/s ({elapsed:.3f} s for {len(volumes)}), "
        f"peak memory {peak:.2f} GiB, model batch {pred.model_batch}")
    log(f"  launches in the serve run: {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    profile_volume(torch, pred, volumes[1])
    return launches, vps


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not (REPO / "mlagg_unet_torch" / "csrc").is_dir():
        fail(f"{REPO} is not a checkout of the repository (no mlagg_unet_torch/csrc)")
    sys.path.insert(0, str(REPO))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi: no output"
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from mlagg_unet_torch.ops import _ext
    from mlagg_unet_torch.ops import flash_attention, mlla_fused, selective_scan_cuda  # noqa: F401

    secs = _ext.build_all()
    log(f"[build] {len(_ext.ALL_KERNELS)} kernels from "
        f"{len({id(k.lib) for k in _ext.ALL_KERNELS})} sources in {secs:.1f} s")

    report = Report()
    phase_kernels(torch, report)
    model = phase_model(torch)
    launches, vps = phase_serve(torch, model)

    kernels = report.finish(launches)
    if {k["name"] for k in kernels} != set(launches):
        fail(f"kernels measured {sorted(r['name'] for r in kernels)} != built {sorted(launches)}")
    log(f"[serve] volumes_per_s {vps}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
