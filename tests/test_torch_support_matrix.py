"""The port's support matrix (``icp_tpu_torch.runtime.support_matrix``) and
its checked-in table, on the CPU: every reachable kernel launch was run on
the card by the sources in this tree, and the matrix covers every row of
the JAX package's matrix."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from icp_tpu.runtime import support_matrix as jax_matrix
from icp_tpu_torch.kernels import native
from icp_tpu_torch.runtime import support_matrix as sm
from icp_tpu_torch.runtime import support_sweep

REGENERATE = ("run `python3 -m icp_tpu_torch.runtime.support_sweep --write` on the card "
              "and commit icp_tpu_torch/runtime/support_table.json")


@pytest.fixture(scope="module")
def table():
    with open(sm.TABLE_PATH) as f:
        return json.load(f)


def test_every_row_is_in_the_table_and_ok(table):
    rows = sm.rows_by_key()
    missing = sorted(set(rows) - set(table["rows"]))
    assert not missing, f"launches never run on the card: {missing}; {REGENERATE}"
    extra = sorted(set(table["rows"]) - set(rows))
    assert not extra, f"the table holds rows the matrix no longer has: {extra}; {REGENERATE}"
    bad = sorted(key for key in rows if not table["rows"][key]["ok"])
    assert not bad, f"launches that failed on the card: {bad}"
    assert table["n_rows"] == len(rows)
    for key in ("e2e-point", "e2e-plane", "e2e-gicp"):
        assert table["rows"][key]["ok"], key


def test_table_digest_is_the_sources(table):
    assert table["digest"] == native.source_digest(), (
        f"the kernels' sources changed since the table was written; {REGENERATE}")
    assert table["wrappers_digest"] == sm.wrappers_digest(), (
        f"the kernels' wrappers or twins changed since the table was written; {REGENERATE}")
    # The card and the build's ptxas report for every source.
    assert "H100" in table["card"]
    assert set(table["ptxas"]) == {p.name for p in native.CSRC.glob("*.cu")}


def test_every_jax_row_has_a_port_row():
    """Each row of the JAX package's matrix has a port row of the same kind,
    variant and class, and the four shared classes have the same n_r, cq
    and cb."""
    port = list(sm.kernel_rows())
    jax_classes = jax_matrix.shape_classes()
    port_classes = sm.shape_classes()
    for name, cfg in jax_classes.items():
        pc = port_classes[name].config
        dims = (cfg.m, cfg.n_r, cfg.query_capacity, cfg.bin_capacity)
        assert (pc.m, pc.n_r, pc.query_capacity, pc.bin_capacity) == dims, name
    for row in jax_matrix.kernel_rows():
        variant = (row.kind, row.shape_class, row.mode, row.weighted, row.robust,
                   row.with_normals)
        matches = [p for p in port if (p.kind, p.shape_class, p.mode, p.weighted, p.robust,
                                       p.with_normals) == variant]
        assert matches, f"no port row for {row.key}"
        cfg = jax_classes[row.shape_class]
        for p in matches:
            if p.n_r:
                assert p.n_r == cfg.n_r, (row.key, p.key)
            if p.cq:
                assert p.cq == cfg.query_capacity, (row.key, p.key)
            if p.cb:
                assert p.cb == cfg.bin_capacity, (row.key, p.key)


def test_knn_capacities_are_the_estimators():
    """knn_capacities gives the (n_r, cq, cb) K8 receives from
    knn_normals_rbc, at its automatic n_r and at an explicit one."""
    from icp_tpu_torch.ops import normals as normals_mod
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    cloud = torch.from_numpy(wavy_surface_pair(2048)[0])
    for n_r in (0, 4):
        got = support_sweep.capture(normals_mod, "bin_knn_moments",
                                    lambda: normals_mod.knn_normals_rbc(cloud, n_r=n_r))[0]
        qp, bins = got[0], got[1]
        assert (qp.shape[0], qp.shape[1], bins.shape[1]) == sm.knn_capacities(2048, n_r)


def test_ptxas_info_reads_the_build_log():
    log = ("== bin_knn_moments.cu\n"
           "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__ce2e4986_18_bin_knn_"
           "moments_cu_b898da5f22bin_knn_moments_kernelILb0EEEvPKfiS2_S2_PKhiiiiPfS5_ii' for "
           "'sm_90a'\nptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
           "ptxas info    : Used 47 registers, used 1 barriers, 32 bytes smem\n"
           "== rep_assign_counts.cu\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124rep_assign_counts"
           "_kernelILb1ELb0EEEvPKfS2_S2_iiPiS3_' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 125 registers, used 1 barriers\n")
    info = support_sweep.ptxas_info(log)
    assert info == {
        "bin_knn_moments.cu": [{"kernel": "bin_knn_moments_kernelILb0EE", "registers": 47,
                                "spill_stores": 8, "spill_loads": 4, "smem_bytes": 32}],
        "rep_assign_counts.cu": [{"kernel": "rep_assign_counts_kernelILb1ELb0EE",
                                  "registers": 125, "spill_stores": 0, "spill_loads": 0,
                                  "smem_bytes": 0}]}


def test_matrix_modules_import_no_jax():
    code = ("import sys; import icp_tpu_torch.runtime.support_matrix as sm; "
            "import icp_tpu_torch.runtime.support_sweep; list(sm.kernel_rows()); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'icp_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parent.parent, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
