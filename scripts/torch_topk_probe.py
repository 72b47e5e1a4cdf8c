"""The retrieval kernels B5 (`extract_topk`) and K3 (`row_max_gemm`) alone,
on the card.

    python scripts/torch_topk_probe.py [--root DIR] [--digests] [--eval]

It builds `extract_topk` and `row_max`, prints ptxas's register, spill and
shared-memory lines of every instance of their kernels, then:
- B5 at phase 2's shape (a 4096-row query tile against 1.28M refs, e 4,
  tile_r 1024, k 128; f16 D 512, f32 D 512, f16 D 511) against its plain
  version (`chip_smoke.check_topk_kernel`), each case with its product
  loop (`topk_route`);
- B5's selection share on the tensor-core route: the kernel against its
  probe variant that runs the same products and skips the selection;
- K3 at the query pass's shape ([27,511] x [2000,511]) and at the eval's
  score-norm shape ([32000,511] x [128000,511]), kernel and plain times
  and max |err|, with the grid of `row_max_grid`;
- with `--digests`, the sha256 of B5's outputs on `b5_digest_args` (f32 D
  512 and f16 D 511 take the FFMA route; tests/test_torch_cuda.py pins
  them);
- with `--eval`, the eval corpus of `chip_smoke.EVAL_SIZES` score-normalised
  (1,000 query videos), and `chip_smoke.check_b5_against_exact`: max |err|
  of `row_topk` on B5 against the exact per-tile path for 256 sampled
  rows, and how many rows failed B5's certificate and were rescanned.

`--root` runs another checkout's kernels and wrappers, such as the parent
commit unpacked with `git archive` into a gitignored directory, so that
two versions are compared in one call on one card (in turns: old, new,
new, old). What the other checkout lacks (the route, the probe variant,
`row_max_grid`) is left out of its run.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--digests", action="store_true")
    ap.add_argument("--eval", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from vsc22_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("torch_topk_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    print(f"root {root}; {chip_smoke.card_line()}", flush=True)
    t0 = time.perf_counter()
    for name in ("extract_topk", "row_max"):
        build.library(name)
    print(f"built extract_topk, row_max in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("extract_topk", "row_max"):
        for line in ptxas_lines(build.build_log(name)):
            print(f"  {name}: {line}", flush=True)
    try:
        if args.digests:
            for dt, d in DIGEST_CASES:
                print(f"B5 {dt} D{d}: sha256 {b5_digest(dt, d, device)}", flush=True)
        b5_cases(chip_smoke, device)
        selection_share(chip_smoke, build, device)
        k3_cases(chip_smoke, device)
        if args.eval:
            eval_certificate(chip_smoke, device)
    except chip_smoke.Failed as e:
        print(f"torch_topk_probe: FAILED: {e}", flush=True)
        return 1
    return 0


def ptxas_lines(log: str) -> list:
    """'kernel: registers, spills, shared memory' for each compiled entry."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
            entry = demangle(entry)
        elif entry and ("registers" in line or "spill" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return out


def demangle(name: str) -> str:
    try:
        return subprocess.run(["c++filt", name], capture_output=True, text=True,
                              timeout=10).stdout.strip() or name
    except (OSError, subprocess.SubprocessError):
        return name


def b5_cases(chip_smoke, device) -> None:
    from vsc22_tpu_torch.ops import topk

    t0 = time.perf_counter()
    if hasattr(topk, "topk_route"):
        print("B5 routes at phase 2's shape: f16 D512 "
              f"{route_of(topk, torch_dtype('f16'), 512, device)}, f32 D512 "
              f"{route_of(topk, torch_dtype('f32'), 512, device)}, f16 D511 "
              f"{route_of(topk, torch_dtype('f16'), 511, device)}", flush=True)
    chip_smoke.check_topk_kernel(device)
    print(f"B5 checks took {time.perf_counter() - t0:.1f} s", flush=True)


def torch_dtype(tag: str):
    import torch

    return {"f16": torch.float16, "f32": torch.float32}[tag]


def route_of(topk, dt, d, device) -> str:
    import torch

    q = torch.zeros((4, d), dtype=dt, device=device)
    return topk.topk_route(dt, d, q, q)


# B5 at the eval's search shape (phase 2's case), for the selection share.
B5_SHAPE = dict(nq=4096, nr=1_280_000, nv=1_279_000, d=512, e=4, tile_r=1024)


def selection_share(chip_smoke, build, device) -> None:
    """B5's kernel on the tensor-core route against its probe variant,
    which runs the same products and skips the selection (staging, folds,
    merge of the two half rows): the selection's share of the kernel. The
    wrapper's time beyond the kernel is `merge_blocks` (torch)."""
    import torch

    lib = build.library("extract_topk")
    if not hasattr(lib, "vsc22_extract_topk_products"):
        print("B5 selection share: this checkout has no probe variant", flush=True)
        return
    from vsc22_tpu_torch.ops import topk

    c = B5_SHAPE
    nq, nr, d, nv, e, tile_r = (c[k] for k in ("nq", "nr", "d", "nv", "e", "tile_r"))
    gen = torch.Generator(device=device).manual_seed(3)
    q = chip_smoke.unit_rows(gen, nq, d, device).half()
    r = chip_smoke.unit_rows(gen, nr, d, device).half()
    nb = -(-nr // tile_r)
    out_s = torch.empty((nb, e, nq), device=device)
    out_i = torch.empty((nb, e, nq), dtype=torch.int32, device=device)
    stream = build.stream_ptr(device)

    def kernel():
        build.call("extract_topk", "vsc22_extract_topk", topk._ARGTYPES, q.data_ptr(),
                   r.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), nq, nr, d, nv, tile_r, e,
                   nb, 1, 1, stream)

    def products():
        build.call("extract_topk", "vsc22_extract_topk_products",
                   [build.PTR] * 3 + [build.INT] * 6 + [build.PTR], q.data_ptr(),
                   r.data_ptr(), out_s.data_ptr(), nq, nr, d, nv, tile_r, nb, stream)

    wrapper = lambda: topk.extract_topk(q, r, nv, e=e, tile_r=tile_r, k=128)
    times = {}
    for name, f in (("kernel", kernel), ("products", products), ("wrapper", wrapper),
                    ("wrapper", wrapper), ("products", products), ("kernel", kernel)):
        times.setdefault(name, []).append(chip_smoke.cuda_ms(f, 5))
    t_k, t_p, t_w = (min(times[n]) for n in ("kernel", "products", "wrapper"))
    flops = 2 * nq * nv * d
    print(f"B5 f16 D512 on the tensor-core route: kernel {t_k:.3f} ms "
          f"({flops / t_k / 1e9:.1f} TFLOP/s), products alone {t_p:.3f} ms "
          f"({flops / t_p / 1e9:.1f} TFLOP/s), selection share {(t_k - t_p) / t_k:.1%}; "
          f"wrapper {t_w:.3f} ms (merge_blocks {t_w - t_k:.3f} ms); turns {times}", flush=True)
    del q, r, out_s, out_i
    torch.cuda.empty_cache()


K3_SHAPES = ((27, 2000, 511), (32000, 128000, 511))


def k3_cases(chip_smoke, device) -> None:
    import torch

    from vsc22_tpu_torch.ops import sim

    gen = torch.Generator(device=device).manual_seed(4)
    for nq, nr, d in K3_SHAPES:
        q = chip_smoke.unit_rows(gen, nq, d, device)
        r = chip_smoke.unit_rows(gen, nr, d, device)
        got = sim.row_max_gemm(q, r)
        want = sim.row_max_gemm_reference(q, r)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        reps = 20 if nq < 1000 else 3
        ms = chip_smoke.cuda_ms(lambda: sim.row_max_gemm(q, r), reps)
        plain_ms = chip_smoke.cuda_ms(lambda: sim.row_max_gemm_reference(q, r), reps)
        grid = sim.row_max_grid(nq, nr) if hasattr(sim, "row_max_grid") else "n/a"
        b = chip_smoke.bound(2 * nq * nr * d, 4 * (nq * d + nr * d + nq), torch.float16)
        ok = err <= chip_smoke.ROW_MAX_TOL[0]
        print(f"K3 [{nq},{d}]x[{nr},{d}] grid {grid}: max_abs_err {err:.3e} (tol "
              f"{chip_smoke.ROW_MAX_TOL[0]:g}) {'ok' if ok else 'FAIL'}; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']})",
              flush=True)
        chip_smoke.check(ok, f"K3 [{nq},{nr},{d}] disagrees with its plain version")
        if nq < 1000:
            k3_device_time(lambda: sim.row_max_gemm(q, r), ms)
            if hasattr(sim, "padded_width"):  # not in checkouts before the f16 tile
                k3_host_split(q, r)
        del q, r, got, want
        torch.cuda.empty_cache()


def host_ms(call, n: int = 200) -> float:
    """The host's milliseconds per call over n calls back to back."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    t = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return t


def k3_host_split(q, r) -> None:
    """The host's time per call of K3's wrapper by piece: the scratch and
    output allocations, the stream lookup, and the C call alone (three
    launches) on buffers allocated before. Written for this checkout's
    wrapper; other checkouts skip it."""
    import torch

    from vsc22_tpu_torch.kernels import build
    from vsc22_tpu_torch.ops import sim

    nq, (nr, d) = q.shape[0], r.shape
    dp, device = sim.padded_width(d), q.device
    scratch = torch.empty((nq + nr) * dp, dtype=torch.float16, device=device)
    out = torch.empty(nq, device=device)
    splits = sim.row_max_grid(nq, nr)[1]
    stream = build.stream_ptr(device)
    parts = {
        "2 torch.empty": lambda: (torch.empty(nq, device=device),
                                  torch.empty((nq + nr) * dp, dtype=torch.float16,
                                              device=device)),
        "stream_ptr": lambda: build.stream_ptr(device),
        "C call": lambda: build.call("row_max", "vsc22_row_max", sim._ARGTYPES, q.data_ptr(),
                                     r.data_ptr(), scratch.data_ptr(), out.data_ptr(), nq, nr,
                                     d, dp, splits, stream),
        "wrapper": lambda: sim.row_max_gemm(q, r),
    }
    print("  K3 host ms per call: " + ", ".join(f"{k} {host_ms(f):.4f}"
                                                 for k, f in parts.items()), flush=True)


def k3_device_time(call, ms: float, calls: int = 20) -> None:
    """K3's device time per call by kernel (torch.profiler over `calls`
    calls) and the host's time per call (its clock over 200 calls, synced
    once at the end), beside the call's time on CUDA events (`ms`): where
    the host's time is the larger, it is what the events measure."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    print(f"  K3 host time per call {host_ms(call):.4f} ms (200 calls back to back)",
          flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / calls, e.count // calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(r[1] for r in rows)
    print(f"  K3 device time per call {total / 1e3:.4f} ms (events: {ms:.3f} ms): "
          + ", ".join(f"{k.split('(')[0].split('::')[-1]} {us:.1f} us x{n}"
                      for k, us, n in rows),
          flush=True)


def eval_certificate(chip_smoke, device) -> None:
    from vsc22_tpu_torch.retrieval.score_norm import (
        _min_variance_dim,
        query_score_normalize,
        ref_score_normalize,
    )

    sizes = chip_smoke.EVAL_SIZES
    t0 = time.perf_counter()
    queries, refs, noise, _ = chip_smoke.make_corpus(
        sizes["eval_queries"], sizes["refs"], sizes["noise"], sizes["frames"], sizes["dim"],
        sizes["planted"])
    low_var = _min_variance_dim(noise)
    sn_q = query_score_normalize(queries, noise, low_var_dim=low_var, beta=1.2, nk=1,
                                 device=device)
    sn_refs = ref_score_normalize(refs, noise, beta=1.2, nk=1)
    print(f"eval corpus and score-norm in {time.perf_counter() - t0:.1f} s", flush=True)
    chip_smoke.check_b5_against_exact(sn_q, sn_refs, device)


# (dtype, D) of the digest cases: both on the FFMA route.
DIGEST_CASES = (("f32", 512), ("f16", 511))


def b5_digest_args(dt: str, d: int, device):
    """B5's operands and options for a digest: 300 query rows against
    20,000 refs of N(0, 1/D) entries from a CPU generator seeded by D,
    the last 10 refs masked, e 4 over 1024-column blocks, k 32."""
    import torch

    gen = torch.Generator().manual_seed(d)
    q = (torch.randn((300, d), generator=gen) * d**-0.5).to(torch_dtype(dt)).to(device)
    r = (torch.randn((20000, d), generator=gen) * d**-0.5).to(torch_dtype(dt)).to(device)
    return (q, r, 19990), dict(e=4, tile_r=1024, k=32)


def b5_digest(dt: str, d: int, device) -> str:
    """sha256 of B5's scores, columns and bound on `b5_digest_args`."""
    import torch

    from vsc22_tpu_torch.ops.topk import extract_topk

    a, kw = b5_digest_args(dt, d, device)
    out = extract_topk(*a, **kw)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


if __name__ == "__main__":
    sys.exit(main())
