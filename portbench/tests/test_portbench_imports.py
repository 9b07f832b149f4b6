"""No run loads jax, jaxlib, flax or icp_tpu (by whole top-level name), and
the plain reference loads nothing of icp_tpu_torch."""

import subprocess
import sys

from conftest import ROOT
from portbench.run import loaded_forbidden


def test_top_level_names_are_compared_whole():
    assert loaded_forbidden(["icp_tpu_torch", "icp_tpu_torch.icp.run", "torch"]) == []
    assert loaded_forbidden(["icp_tpu.icp.run", "jax.numpy", "jaxlib", "flax.linen",
                             "jaxtyping"]) == ["flax", "icp_tpu", "jax", "jaxlib"]


def _modules_after(code: str) -> set:
    proc = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return {m.split(".")[0] for m in proc.stdout.split()}


def test_the_reference_loads_nothing_of_the_port():
    names = _modules_after("import portbench.reference.icp, portbench.reference.normals, "
                           "portbench.reference.point_plane")
    assert "icp_tpu_torch" not in names and not loaded_forbidden(names)


def test_a_run_loads_no_jax_nor_the_jax_package():
    names = _modules_after(
        "import sys; sys.path.insert(0, 'portbench/tests')\n"
        "from conftest import tiny\nfrom portbench import run, spec\n"
        "run.run_cell(tiny(spec.cell('kinect.stream'), 1024, 16, pool=2), 5, 0.0, False, 'cpu')")
    assert "icp_tpu_torch" in names
    assert loaded_forbidden(names) == []
