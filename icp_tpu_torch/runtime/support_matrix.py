"""The supported-configuration matrix of the port: every kernel launch
(kernel x variant x shape) that a configuration the package promises can
reach, and the checked-in record of what each did on the card (port of
``icp_tpu.runtime.support_matrix``).

A kernel's launch depends on its shapes: shared memory, the number of
tiles a search walks, the grid. The CPU tests run only the plain twins and
cannot see a launch that the card refuses, so this module names every
reachable launch once, and both sides read it:

- ``python -m icp_tpu_torch.runtime.support_sweep --write``, on the card,
  runs every row of :func:`kernel_rows` on the arguments the main path
  hands its wrapper, holds it against its twin and writes the result to
  :data:`TABLE_PATH`, keyed by :func:`icp_tpu_torch.kernels.native.source_digest`
  and :func:`wrappers_digest`. Run it again after any change under ``csrc/``
  or ``kernels/`` (the wrappers and their twins), or to the capacity rules
  (``runtime/config.py``), the pyramid's levels (``icp/pyramid.py``), the
  sharded capacity (``parallel/sharded.py``) or the kNN estimator's
  capacities (``ops/normals.py``), and commit the table.
- ``tests/test_torch_support_matrix.py`` checks on the CPU that every row's
  key is in the table and ``ok``, and that the table's digests are those of
  the sources and wrappers in the tree; ``chip_smoke.py`` phase 5 runs the sweep again on
  the card and compares.

A row's key carries the kernel, the variant and every dimension that
decides its launch, so a change of capacity policy changes a key and the
table no longer covers it.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Iterator, NamedTuple

TABLE_PATH = Path(__file__).resolve().with_name("support_table.json")

# The robust kernels of K3 at the flagship (the body changes with the
# robust kind; the other classes cover the layouts with the default body).
_ROBUST_FULL = ("none", "trimmed", "huber", "tukey")

# kind -> the wrapper (and launch counter) that runs it; the JAX package's
# kinds, and the port's kNN kernels and end-to-end registrations.
KERNEL_OF = {
    "repassignc": "rep_assign_counts",  # K1
    "repassign": "rep_assign",          # K1'
    "table": "bin_table",               # K2
    "point": "bin_point_moments",       # K3
    "mindist": "bin_min_dists",         # K4
    "binsearch": "bin_search",          # K5
    "brute": "brute_nn",                # K6
    "gn": "bin_gn_moments",             # K7
    "knn": "bin_knn_moments",           # K8
    "top2": "rep_top2_counts",          # K9
    "e2e": None,
}


class ShapeClass(NamedTuple):
    """One supported shape.

    family: "register" (a registration at ``config``: its index build and
      steps), "assign" (K1 and K1' alone at ``config``'s m and n_r: the index
      build at that n_r is a plain product outside any kernel), "sharded"
      (one rank's step of ``config`` on a ``mesh`` of (n_dp, n_mp) ranks) or
      "knn" (``knn_normals_rbc`` on ``points`` wavy-surface points with
      representative count ``knn_n_r``, 0 for its automatic choice).
    pair: the landmarks of the class: "synthetic" (``synthetic_pair``) or
      "wavy" (``wavy_surface_pair``); GN steps at m <= 16384 take the
      rendered gate pair (its pyramid level below).
    """

    config: object
    family: str = "register"
    pair: str = "synthetic"
    mesh: tuple = (1, 1)
    points: int = 0
    knn_n_r: int = 0


class KernelRow(NamedTuple):
    """One launch verified on the card.

    key: the kernel, its variant and every dimension that decides its
      launch.
    kind: one of :data:`KERNEL_OF`'s keys.
    shape_class: a name of :func:`shape_classes`.
    mode / weighted / robust / with_normals: the variant (unused fields hold
      the kind's defaults), as the JAX package's rows name them.
    n_r, cq, cb: the bins, query slots and bin slots the kernel sees (K1 and
      K9: the representatives; K2: bins and capacity); m the rows; width the
      lanes of K2's rows or K5's payload (0 where it does not apply).
    """

    key: str
    kind: str
    shape_class: str
    mode: str = "plane"
    weighted: bool = True
    robust: str = "none"
    with_normals: bool = False
    m: int = 0
    n_r: int = 0
    cq: int = 0
    cb: int = 0
    width: int = 0


def wrappers_digest() -> str:
    """sha256 of every ``kernels/*.py`` (name and bytes): the wrappers, their
    twins and the grouping they launch with, which decide what a row launches
    and what it is held against as much as ``csrc/`` does. Apart from
    ``native.source_digest``, which keys the build, so that a Python edit
    does not rebuild the library."""
    digest = hashlib.sha256()
    for src in sorted((Path(__file__).resolve().parent.parent / "kernels").glob("*.py")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()


def knn_capacities(points: int, n_r: int = 0) -> tuple[int, int, int]:
    """(n_r, cq, cb) of ``ops.normals.knn_normals_rbc`` on ``points`` points
    with ``multi_assign`` 2 (n_r 0: its automatic choice)."""
    from icp_tpu_torch.ops.normals import knn_rbc_capacities

    n_r, cq = knn_rbc_capacities(points, n_r)
    return n_r, cq, 2 * cq


def sharded_capacities(config, mesh: tuple) -> tuple[int, int, int]:
    """(bins K2 groups into, query capacity, bin capacity) of one rank of a
    ``mesh`` = (n_dp, n_mp): its n_r / n_mp bins plus the parking bin."""
    from icp_tpu_torch.parallel.sharded import sharded_query_capacity

    n_dp, n_mp = mesh
    return config.n_r // n_mp + 1, sharded_query_capacity(config, n_dp), config.bin_capacity


def shape_classes() -> dict:
    """name -> :class:`ShapeClass` of every supported shape.

    pyr4 / pyr2: the pyramid's coarse levels of the flagship
      (``icp.pyramid._level_config`` with strides 4 and 2).
    flagship: the reference workload (m 16384, n_r 256).
    4x / 16x: the scaled workloads (65536 / 1024, 262144 / 2048).
    nr16 / nr8: few large bins at the flagship m (cq 1536 / 3072, cb 2048 /
      4096), as the adaptive robust cases reach.
    nr65536: K1 at n_r 65536 on 262144 rows, past the size where its
      shared count histogram fits.
    sharded-DxM: one rank of the flagship on a (D, M) mesh.
    knn-*: the kNN normal estimator: the LiDAR sweep (262144 points, n_r
      2048), the GICP "knn_rbc" cloud (16384, n_r 128), 2^21 + 128 points
      (automatic n_r 32768) and an explicit n_r 128 on 262144 points (cq
      3072, cb 6144).
    """
    from icp_tpu_torch.icp.pyramid import _level_config
    from icp_tpu_torch.runtime.config import ICPConfig

    base = ICPConfig()
    classes = {
        "pyr4": ShapeClass(_level_config(base, 4)),
        "pyr2": ShapeClass(_level_config(base, 2)),
        "flagship": ShapeClass(base),
        "4x": ShapeClass(ICPConfig(m=65536, n_r=1024), pair="wavy"),
        "16x": ShapeClass(ICPConfig(m=262144, n_r=2048), pair="wavy"),
        "nr16": ShapeClass(ICPConfig(n_r=16)),
        "nr8": ShapeClass(ICPConfig(n_r=8)),
        "nr65536": ShapeClass(ICPConfig(m=262144, n_r=65536), family="assign"),
    }
    for mesh in ((1, 1), (2, 1), (1, 2), (2, 2)):
        classes[f"sharded-{mesh[0]}x{mesh[1]}"] = ShapeClass(base, family="sharded", mesh=mesh)
    for name, points, n_r in (("knn-lidar", 262144, 0), ("knn-16384", 16384, 0),
                              ("knn-2m", 2 ** 21 + 128, 0), ("knn-nr128", 262144, 128)):
        classes[name] = ShapeClass(base, family="knn", pair="wavy", points=points,
                                   knn_n_r=n_r)
    return classes


# The sharded variants and the kernel each hands its grouped queries to:
# K3 for POINT, K5's per-pair search for the GN objectives and the
# robust-adaptive scale. K5's payload is the 12-wide [bins | normals | 0].
SHARDED_VARIANTS = {"point": ("point", 8), "plane": ("binsearch", 12),
                    "gicp": ("binsearch", 12), "robust": ("binsearch", 12)}
# The widths of the queries K2 groups on a sharded step: the moving rows,
# with their normals for the GN objectives.
SHARDED_TABLE_WIDTH = {"point": 8, "plane": 11, "gicp": 11, "robust": 11}


def _register_rows(name: str, sc: ShapeClass) -> Iterator[KernelRow]:
    from icp_tpu_torch.kernels.fused_gn import GN_MODES

    cfg = sc.config
    n_r, cq, cb, m = cfg.n_r, cfg.query_capacity, cfg.bin_capacity, cfg.m
    flag = name == "flagship"
    dims = f"{n_r}x{cq}x{cb}"
    for kind in ("repassign", "repassignc"):
        yield KernelRow(f"{kind}|m{m}|nr{n_r}", kind, name, m=m, n_r=n_r)
    if sc.family == "assign":
        return
    # K2: d 8 groups the queries alone (POINT), d 11 the queries and their
    # normals (PLANE, plane_sym, GICP).
    for d in (8, 11):
        yield KernelRow(f"table|m{m}|nr{n_r}|cap{cq}|d{d}", "table", name,
                        with_normals=d == 11, m=m, n_r=n_r, cq=cq, width=d)
    for weighted in ((True, False) if flag else (True,)):
        for robust in (_ROBUST_FULL if flag else ("none",)):
            yield KernelRow(f"point|{dims}|w{int(weighted)}|{robust}", "point", name,
                            weighted=weighted, robust=robust, n_r=n_r, cq=cq, cb=cb)
    yield KernelRow(f"mindist|{dims}", "mindist", name, n_r=n_r, cq=cq, cb=cb)
    for mode in GN_MODES:
        variants = ([(True, "none"), (True, "trimmed"), (False, "none")] if flag
                    else [(True, "none")])
        for weighted, robust in variants:
            yield KernelRow(f"gn-{mode}|{dims}|w{int(weighted)}|{robust}", "gn", name,
                            mode=mode, weighted=weighted, robust=robust,
                            n_r=n_r, cq=cq, cb=cb)
    for with_normals in (False, True):
        v = 12 if with_normals else 8
        yield KernelRow(f"binsearch|{dims}|v{v}", "binsearch", name,
                        with_normals=with_normals, n_r=n_r, cq=cq, cb=cb, width=v)
    if flag:
        yield KernelRow(f"brute|m{m}|n{m}", "brute", name, m=m)


def kernel_rows() -> Iterator[KernelRow]:
    """Every row of the support matrix, in a fixed order."""
    for name, sc in shape_classes().items():
        cfg = sc.config
        if sc.family in ("register", "assign"):
            yield from _register_rows(name, sc)
        elif sc.family == "sharded":
            n_bins, cap, cb = sharded_capacities(cfg, sc.mesh)
            mesh = f"mesh{sc.mesh[0]}x{sc.mesh[1]}"
            for variant, (kind, v) in SHARDED_VARIANTS.items():
                d = SHARDED_TABLE_WIDTH[variant]
                m_local = cfg.m // sc.mesh[0]
                yield KernelRow(f"table|{mesh}|{variant}|m{m_local}|nr{n_bins}|cap{cap}|d{d}",
                                "table", name, with_normals=d == 11, m=m_local,
                                n_r=n_bins, cq=cap, width=d)
                dims = f"{n_bins - 1}x{cap}x{cb}"
                if kind == "point":
                    yield KernelRow(f"point|{mesh}|{dims}|w1|none", "point", name,
                                    n_r=n_bins - 1, cq=cap, cb=cb)
                else:
                    yield KernelRow(f"binsearch|{mesh}|{variant}|{dims}|v{v}", "binsearch",
                                    name, with_normals=True, n_r=n_bins - 1, cq=cap, cb=cb,
                                    width=v)
        else:
            n_r, cq, cb = knn_capacities(sc.points, sc.knn_n_r)
            yield KernelRow(f"top2|m{sc.points}|nr{n_r}", "top2", name, m=sc.points, n_r=n_r)
            yield KernelRow(f"knn|{n_r}x{cq}x{cb}|k16", "knn", name, n_r=n_r, cq=cq, cb=cb)
            # The estimator's groupings: the queries with their ids (d 4),
            # then the second choices (d 3).
            for d in (4, 3):
                yield KernelRow(f"table|knn|m{sc.points}|nr{n_r}|cap{cq}|d{d}", "table", name,
                                m=sc.points, n_r=n_r, cq=cq, width=d)
    # Whole registrations at the flagship, on the card against the CPU.
    for objective in ("point", "plane", "gicp"):
        yield KernelRow(f"e2e-{objective}", "e2e", "flagship", mode=objective)


def rows_by_key() -> dict:
    """key -> :class:`KernelRow`; the keys are unique."""
    rows = {}
    for row in kernel_rows():
        if row.key in rows:
            raise AssertionError(f"duplicate support-matrix key {row.key}")
        rows[row.key] = row
    return rows

