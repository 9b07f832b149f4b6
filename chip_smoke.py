#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (icp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU fallback):

1. Device: require CUDA, print the card (nvidia-smi name and power limit),
   the torch and nvcc versions, and build the kernels from csrc/.
2. Kernels against their plain PyTorch twins on the card, on the tensors of
   the first iteration of the flagship pair (m=16384, n_r=256): K2 bitwise;
   K1 exact counts, rid agreement >= 99.9% with every disagreement a
   float64 near-tie; K3 max|dP| <= 1e-4 max|P|.
3. The slice: register three flagship pairs (seeds 0, 1, 2) with the
   default ICPConfig through icp_tpu_torch.register on CUDA tensors; each
   must land within 0.05 mm and 0.005 deg of the ground truth, the launch
   counters must show every kernel ran at least k times, and seed 0 must
   agree with the same registration on the CPU (the twins) within 0.01 mm
   and 0.001 deg.
4. Times, printed, never gated: the marginal ms per iteration (thresholds
   0, max_iterations 40 against 8, minimum of alternating rounds for each
   before differencing, as bench.py does) and each kernel against its twin
   with CUDA events.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
M, N_R = 16384, 256
ALPHA = 2e2  # the benchmark's blend (bench.py)
# Ground truth of __graft_entry__._synthetic_pair: +0.02 rad about z and
# t = (8, -5, 3) mm, for any seed.
Q_GT = np.array([0.0, 0.0, np.sin(0.01), np.cos(0.01)])
T_GT = np.array([8.0, -5.0, 3.0])
ROUNDS = 5


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def _errors(state):
    """(t_err mm, a_err deg) of a registration against the ground truth."""
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    q_gt = torch.tensor(Q_GT, dtype=torch.float32)
    t_err = float(np.linalg.norm(state.t.double().cpu().numpy() - T_GT))
    a_err = float(qangle_deg(qmul(state.q.cpu(), qconj(q_gt))))
    return t_err, a_err


def _cuda_ms(fn, reps: int = 20) -> float:
    """Mean device ms of one call of ``fn`` over ``reps`` back-to-back calls.

    The card first spins for ~0.2 s, so the host has queued every call
    before the start event runs: the events then time the device work and
    not the host's launch rate (a kernel of a few microseconds is shorter
    than its Python wrapper).
    """
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _synthetic_pair
    from icp_tpu_torch import ICPConfig, ICPParams, register
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.kernels import native
    from icp_tpu_torch.kernels import table_build as tb
    from icp_tpu_torch.rbc import grouping

    dev = torch.device("cuda", 0)

    # ---- 1. Device and build ----------------------------------------------
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader", "--id=0"])
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(_run([native._nvcc(), "--version"]).splitlines()[-1], flush=True)
    native.load_library()
    print(f"kernel build: {native.build_info['seconds']:.2f} s "
          f"({native.build_info['path']})", flush=True)
    for line in native.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip(), flush=True)

    cfg = ICPConfig()
    params = ICPParams(alpha=ALPHA)
    fixed_np, moving_np = _synthetic_pair(M, seed=0)
    fixed = torch.from_numpy(fixed_np).to(dev)
    moving = torch.from_numpy(moving_np).to(dev)

    # ---- 2. Kernels against their twins, first iteration's tensors ---------
    index = build_index(fixed, params.to(dev), cfg)
    st0 = identity_state(torch.float32, dev)
    alpha = torch.tensor(ALPHA, dtype=torch.float32, device=dev)
    G, b_row = fs.prep_similarity(st0.q, st0.t, st0.s)
    G = G.contiguous()
    C, srow = fs.prep_rep_assign(index.reps, alpha, G, b_row)
    C = C.contiguous()

    rid_k, counts_k = fs.rep_assign_counts(moving, C, srow)
    rid_t, counts_t = fs.rep_assign_counts_ref(moving, C, srow)
    torch.cuda.synchronize()
    if not torch.equal(counts_k, torch.bincount(rid_k, minlength=N_R).to(torch.int32)):
        raise AssertionError("K1 counts != bincount(rid)")
    if int(counts_k.sum()) != M:
        raise AssertionError(f"K1 counts sum {int(counts_k.sum())} != {M}")
    agree = float((rid_k == rid_t).float().mean())
    score64 = srow.double() - 2.0 * (moving.double() @ C.double())
    best64 = score64.min(dim=1).values
    picked = score64.gather(1, rid_k.long()[:, None])[:, 0]
    excess = ((picked - best64) / best64.abs().clamp(min=1.0))
    diff = rid_k != rid_t
    worst = float(excess[diff].max()) if bool(diff.any()) else 0.0
    print(f"K1 rep_assign_counts: rid agreement {agree:.6f} "
          f"({int(diff.sum())} of {M} differ), worst float64 excess of a "
          f"differing pick {worst:.3e}", flush=True)
    if agree < 0.999:
        raise AssertionError(f"K1 rid agreement {agree} < 0.999")
    if worst > 1e-5:
        raise AssertionError(f"K1 differing pick is not a near-tie: {worst}")
    k1_err = int((counts_k - counts_t).abs().max())

    sidx, counts, offsets, valid = grouping.bin_sort_layout(
        rid_k, N_R, cfg.query_capacity, counts=counts_k)
    sorted_rows = torch.index_select(moving, 0, sidx).contiguous()
    table_k = tb.bin_table(sorted_rows, offsets, capacity=cfg.query_capacity)
    table_t = tb.bin_table_ref(sorted_rows, offsets, capacity=cfg.query_capacity)
    torch.cuda.synchronize()
    if not torch.equal(table_k.view(torch.int32), table_t.view(torch.int32)):
        raise AssertionError("K2 bin_table is not bitwise equal to its twin")
    k2_err = float((table_k - table_t).abs().max())
    print("K2 bin_table: bitwise equal to its twin", flush=True)

    qvalid = valid.to(torch.float32)
    k3_args = (table_k, qvalid, index.reps, index.bins_centered,
               index.sq_b_masked, G, b_row, alpha)
    P_k = fs.bin_point_moments(*k3_args, weighted=True)
    P_t = fs.bin_point_moments_ref(*k3_args, weighted=True)
    torch.cuda.synchronize()
    k3_err = float((P_k - P_t).abs().max())
    k3_scale = float(P_t.abs().max())
    print(f"K3 bin_point_moments: max|dP| {k3_err:.4e} vs max|P| "
          f"{k3_scale:.4e} (ratio {k3_err / k3_scale:.3e}, bound 1e-4)",
          flush=True)
    if not k3_err <= 1e-4 * k3_scale:
        raise AssertionError("K3 disagrees with its twin")

    # ---- 3. The slice: three flagship registrations ------------------------
    counters = {"rep_assign_counts": fs.rep_assign_counts,
                "bin_table": tb.bin_table,
                "bin_point_moments": fs.bin_point_moments}
    for fn in counters.values():
        fn.launches = 0
    results = {}
    for seed in (0, 1, 2):
        before = {name: fn.launches for name, fn in counters.items()}
        f_np, m_np = _synthetic_pair(M, seed=seed)
        t0 = time.perf_counter()
        st = register(torch.from_numpy(f_np).to(dev),
                      torch.from_numpy(m_np).to(dev), params, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k = int(st.k)
        t_err, a_err = _errors(st)
        ran = {name: fn.launches - before[name] for name, fn in counters.items()}
        results[seed] = st
        print(f"register seed {seed} on {torch.cuda.get_device_name(0)}: k={k} "
              f"t_err={t_err:.6f} mm a_err={a_err:.7f} deg wall={wall:.3f} s "
              f"launches={ran}", flush=True)
        if not (t_err < 0.05 and a_err < 0.005):
            raise AssertionError(f"seed {seed}: registration off the ground truth")
        for name, n in ran.items():
            if n < k:
                raise AssertionError(f"{name} launched {n} < k={k} times")
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")

    st_cpu = register(torch.from_numpy(fixed_np), torch.from_numpy(moving_np),
                      params, cfg)
    if any(fn.launches != launches[name] for name, fn in counters.items()):
        raise AssertionError("a CPU registration launched a kernel")
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    st_gpu = results[0]
    dt = float(np.linalg.norm(st_gpu.t.double().cpu().numpy()
                              - st_cpu.t.double().numpy()))
    dang = float(qangle_deg(qmul(st_gpu.q.cpu(), qconj(st_cpu.q))))
    print(f"seed 0 card vs CPU twins: k {int(st_gpu.k)} vs {int(st_cpu.k)} "
          f"(JAX reference on CPU: 10), |dt|={dt:.6f} mm, dangle={dang:.7f} deg",
          flush=True)
    if not (dt <= 0.01 and dang <= 0.001):
        raise AssertionError("card and CPU registrations disagree")

    # ---- 4. Times (printed, not gated) ------------------------------------
    fast = ICPParams(alpha=ALPHA, angle_threshold_deg=0.0,
                     translation_threshold=0.0)
    best = {40: float("inf"), 8: float("inf")}
    for _ in range(ROUNDS):
        for iters in (40, 8):
            t0 = time.perf_counter()
            st = register(fixed, moving, fast, ICPConfig(max_iterations=iters))
            torch.cuda.synchronize()
            best[iters] = min(best[iters], time.perf_counter() - t0)
            if int(st.k) != iters:
                raise AssertionError(f"k={int(st.k)} != {iters}")
    per_iter = (best[40] - best[8]) / 32 * 1e3
    print(f"marginal ms/iteration at {M}x{N_R}: {per_iter} "
          f"(T40 {best[40] * 1e3} ms, T8 {best[8] * 1e3} ms, "
          f"min of {ROUNDS} alternating rounds)", flush=True)

    table_args = (sorted_rows, offsets)
    pairs = {
        "rep_assign_counts": (lambda: fs.rep_assign_counts(moving, C, srow),
                              lambda: fs.rep_assign_counts_ref(moving, C, srow)),
        "bin_table": (lambda: tb.bin_table(*table_args, capacity=cfg.query_capacity),
                      lambda: tb.bin_table_ref(*table_args, capacity=cfg.query_capacity)),
        "bin_point_moments": (lambda: fs.bin_point_moments(*k3_args, weighted=True),
                              lambda: fs.bin_point_moments_ref(*k3_args, weighted=True)),
    }
    times = {}
    for name, (kernel, twin) in pairs.items():
        k_ms, t_ms = float("inf"), float("inf")
        for _ in range(3):  # alternate kernel and twin; keep each minimum
            k_ms = min(k_ms, _cuda_ms(kernel))
            t_ms = min(t_ms, _cuda_ms(twin))
        times[name] = (k_ms, t_ms)
        print(f"{name}: kernel {k_ms} ms, plain twin {t_ms} ms", flush=True)

    meta = {
        "rep_assign_counts": ("icp_tpu_torch/csrc/rep_assign_counts.cu",
                              "icp_tpu/kernels/fused_step.py:372", k1_err),
        "bin_table": ("icp_tpu_torch/csrc/bin_table.cu",
                      "icp_tpu/kernels/table_build.py:79", k2_err),
        "bin_point_moments": ("icp_tpu_torch/csrc/bin_point_moments.cu",
                              "icp_tpu/kernels/fused_step.py:564", k3_err),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": err,
                "ms": times[name][0], "plain_ms": times[name][1]}
               for name, (src, rep, err) in meta.items()]
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
