"""The exchange schedules of the port's sharded paths (row, grid and
sequence layouts), counted on its own exchange layer (``parallel.ring``)
and held against the analytic predictions (``parallel.audit.predict_*``)
and against JAX's (``pypwt_tpu.parallel.audit``), which reads the same
schedules from compiled HLO: per level halo-sized ring exchanges only, no
all-gather or all-to-all, one all-reduce per norm, the same counts and
per-shard halo bytes on rings of any size.  Last, ``ProcessGroupRing`` on
4 gloo processes gives exactly the results of ``LocalRing``: the row
layout, a 2 x 2 grid (one process group per row and per column) and a
4-shard signal.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from pypwt_tpu.core import dwt as jdwt
from pypwt_tpu.filters import get_filter_bank as jbank
from pypwt_tpu.parallel import audit as jaudit

from pypwt_tpu_torch import conv, get_filter_bank
from pypwt_tpu_torch.parallel import BatchedWavelets, ShardedWavelets
from pypwt_tpu_torch.parallel import audit, mesh as pmesh
from pypwt_tpu_torch.parallel import ring as pring
from pypwt_tpu_torch.parallel import spatial

CPU = torch.device("cpu")
REPO = os.path.join(os.path.dirname(__file__), os.pardir)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 simulated devices")


def _mesh(n_data, n_rows):
    return pmesh.make_mesh(n_data, n_rows, [CPU] * (n_data * n_rows))


def _counted(fb, levels, n_rows, shape, swt=False):
    """(forward schedule, inverse schedule) of one row-sharded roundtrip."""
    fwd, inv = audit.rowsharded_fns(fb, levels, _mesh(1, n_rows), swt)
    x = torch.from_numpy(np.random.default_rng(0).random(shape))
    fwd.ring.reset()
    pyr = fwd(x)
    f = audit.schedule_of(fwd.ring)
    fwd.ring.reset()
    y = pring.gather_rows(inv(pyr))
    assert float((y - x).abs().max()) < 1e-10
    return f, audit.schedule_of(fwd.ring)


# (bank, levels, shards, image, swt, forward ppermutes by hand)
CASES = [
    ("db2", 3, 8, (256, 64), False, 6),     # (1, 1) rows each way per level
    ("haar", 3, 8, (256, 64), False, 0),    # pads 0: no exchange at all
    ("sym8", 2, 8, (512, 128), False, 4),   # (7, 7) rows, one hop
    ("db20", 1, 8, (128, 64), False, 4),    # (19, 19) rows on 16: 2 hops
    ("db3", 3, 8, (128, 128), True, 6),     # (2, 3), (4, 6), (8, 12)
    ("db3", 4, 8, (128, 128), True, 9),     # L4: (16, 24) on 16 rows
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-L{c[1]}-"
                         f"{'swt' if c[4] else 'dwt'}")
def test_counted_schedule_equals_prediction(case):
    wname, levels, n, shape, swt, by_hand = case
    fb = get_filter_bank(wname)
    f, i = _counted(fb, levels, n, shape, swt)
    pred = audit.predict_rowsharded(fb, levels, *shape, n, swt)
    assert f["ppermute"] == pred["fwd_ppermute"] == by_hand
    assert i["ppermute"] == pred["inv_ppermute"]
    if swt:
        pads = [p for lev in range(1, levels + 1) for inverse in (0, 1)
                for p in conv.swt_pads(fb.hlen, lev, inverse)]
    else:
        pads = [*conv.analysis_pads(fb.hlen), *conv.synthesis_pads(
            fb.hlen, shape[0] // n // 2, shape[0] // n)]
    most = min(max(pads), shape[0] // n) * shape[1]
    for sched in (f, i):
        assert (sched["all_gather"], sched["all_reduce"],
                sched["all_to_all"]) == (0, 0, 0)
        # every exchanged operand is halo-sized: at most the widest pad's
        # rows, and never more than one shard
        assert all(e <= most for e in sched["ppermute_elems"])
    # halo bytes: the forward ppermutes' elements, 4 bytes each in float32
    assert sum(f["ppermute_elems"]) * 4 == pred["fwd_halo_bytes"]


@pytest.mark.parametrize("mode, wname", [("pallas", "db2"),
                                         ("pallas", "sym4"),
                                         ("mxu", "sym8")])
def test_prediction_equals_jax_where_hops_agree(mode, wname):
    """On 8 shards of 64 rows JAX's fused kernels exchange one 8-row
    rounded band each way per level (and per plane back); the port's
    exact pads need one hop too: the same counts."""
    jdwt.set_kernels(mode)
    try:
        ref = jaudit.predict_rowsharded(jbank(wname), 2, 8 * 64, 128, 8)
    finally:
        jdwt.set_kernels("auto")
    got = audit.predict_rowsharded(get_filter_bank(wname), 2, 8 * 64, 128,
                                   8)
    assert (got["fwd_ppermute"], got["inv_ppermute"]) == (
        ref["fwd_ppermute"], ref["inv_ppermute"]) == (4, 16)
    # the bytes differ: exact pads against bands rounded up to 8 rows
    assert got["fwd_halo_bytes"] < ref["fwd_halo_bytes"]


def test_prediction_differs_from_jax_where_it_should():
    """Pinned differences: haar's pads are 0, so the port exchanges
    nothing where JAX's fused kernels still swap a band; JAX's jnp route
    exchanges both column outputs per level forward, the port the input
    once (half the forward exchanges), the same inverse."""
    jdwt.set_kernels("pallas")
    try:
        jax_haar = jaudit.predict_rowsharded(jbank("haar"), 3, 256, 64, 8)
    finally:
        jdwt.set_kernels("auto")
    ours = audit.predict_rowsharded(get_filter_bank("haar"), 3, 256, 64, 8)
    assert ours["fwd_ppermute"] == ours["inv_ppermute"] == 0
    assert jax_haar["fwd_ppermute"] > 0
    jdwt.set_kernels("jnp")
    try:
        jax_jnp = jaudit.predict_rowsharded(jbank("db2"), 3, 256, 64, 8)
    finally:
        jdwt.set_kernels("auto")
    ours = audit.predict_rowsharded(get_filter_bank("db2"), 3, 256, 64, 8)
    assert (jax_jnp["fwd_ppermute"], jax_jnp["inv_ppermute"]) == (12, 24)
    assert (ours["fwd_ppermute"], ours["inv_ppermute"]) == (6, 24)


def test_schedule_is_mesh_size_independent():
    """Counts and per-shard halo bytes do not grow with the ring."""
    fb = get_filter_bank("db4")
    seen = set()
    for n in (2, 4, 8, 16):
        f, i = _counted(fb, 2, n, (n * 32, 64))
        seen.add((f["ppermute"], i["ppermute"],
                  tuple(f["ppermute_elems"]), tuple(i["ppermute_elems"])))
    assert len(seen) == 1


def _grid_mesh(nr, nc):
    return pmesh.make_mesh2d(nr, nc, [CPU] * (nr * nc))


def _schedule(fwd, inv, x):
    fwd.ring.reset()
    pyr = fwd(x)
    f = audit.schedule_of(fwd.ring)
    fwd.ring.reset()
    inv(pyr)
    return f, audit.schedule_of(fwd.ring)


def _no_collective_but_ppermute(*scheds, most):
    for sched in scheds:
        assert (sched["all_gather"], sched["all_reduce"],
                sched["all_to_all"]) == (0, 0, 0)
        assert all(e <= most for e in sched["ppermute_elems"])


@pytest.mark.parametrize("swt", [False, True], ids=["dwt", "swt"])
@pytest.mark.parametrize("mesh", [(4, 2), (2, 4), (1, 8)], ids=str)
def test_grid_schedule_equals_prediction_and_jax(swt, mesh):
    """JAX's cases (tests/test_collectives.py:193-228): db2 L2 on 32 x 64
    shards; per level 1 column exchange + 2 row exchanges forward, 4 row + 2
    column plane exchanges inverse; the same counts as JAX's prediction
    (on a ring of one the port exchanges nothing, as JAX's
    ``axis_size == 1`` path)."""
    fb = get_filter_bank("db2")
    nr, nc = mesh[0] * 32, mesh[1] * 64
    pred = (audit.predict_gridsharded_swt if swt
            else audit.predict_gridsharded)(fb, 2, nr, nc, *mesh)
    fwd, inv = audit.gridsharded_fns(fb, 2, _grid_mesh(*mesh), swt)
    f, i = _schedule(fwd, inv, torch.from_numpy(
        np.random.default_rng(3).random((nr, nc))))
    assert (f["ppermute"], i["ppermute"]) == (pred["fwd_ppermute"],
                                              pred["inv_ppermute"])
    ref = (jaudit.predict_gridsharded_swt if swt
           else jaudit.predict_gridsharded)(jbank("db2"), 2, nr, nc, *mesh)
    if mesh[0] > 1:
        assert pred == ref
    if mesh == (4, 2):
        assert pred["fwd_ppermute"] == (12 if swt else 2 * (2 + 4))
    _no_collective_but_ppermute(f, i, most=4 * 64)


@pytest.mark.parametrize("swt, levels, n", [(False, 2, 4096),
                                            (True, 3, 1024),
                                            (False, 3, 16)], ids=str)
def test_seq_schedule_equals_prediction_and_jax(swt, levels, n):
    """JAX's cases (tests/test_collectives.py:231-252) on 8 shards, and a
    signal of 16-sample shards whose db2 halos still take one hop."""
    fb = get_filter_bank("db2")
    N = 8 * n
    pred = (audit.predict_seqsharded_swt if swt
            else audit.predict_seqsharded)(fb, levels, N, 8)
    ref = (jaudit.predict_seqsharded_swt if swt
           else jaudit.predict_seqsharded)(jbank("db2"), levels, N, 8)
    assert pred == ref
    if n == 4096:
        assert (pred["fwd_ppermute"], pred["inv_ppermute"]) == (4, 8)
    if swt:
        assert (pred["fwd_ppermute"], pred["inv_ppermute"]) == (6, 12)
    fns = audit.seqsharded_swt_fns if swt else audit.seqsharded_fns
    fwd, inv = fns(fb, levels, _mesh(1, 8))
    f, i = _schedule(fwd, inv, torch.from_numpy(
        np.random.default_rng(4).random(N)))
    assert (f["ppermute"], i["ppermute"]) == (pred["fwd_ppermute"],
                                              pred["inv_ppermute"])
    _no_collective_but_ppermute(f, i, most=8)


def test_grid_and_seq_norms_are_the_only_all_reduce():
    img = np.random.default_rng(5).random((64, 64)).astype(np.float32)
    sig = np.random.default_rng(6).random(4096).astype(np.float32)
    for plan in (ShardedWavelets(img, "db2", 2, mesh=_grid_mesh(2, 2)),
                 ShardedWavelets(sig, "db2", 2, mesh=_mesh(1, 8))):
        plan.forward()
        for norm in (plan.norm1, plan.norm2sq):
            plan.ring.reset()
            assert norm() > 0
            assert audit.schedule_of(plan.ring) == {
                "ppermute": 0, "all_gather": 0, "all_reduce": 1,
                "all_to_all": 0, "ppermute_elems": []}


def test_data_parallel_transforms_make_no_exchange():
    stack = np.random.default_rng(1).random((8, 32, 32)).astype(np.float32)
    B = BatchedWavelets(stack, "db2", 2, mesh=_mesh(8, 1))
    B.forward()
    B.soft_threshold(0.1)
    B.inverse()
    assert audit.schedule_of(B.ring) == {
        "ppermute": 0, "all_gather": 0, "all_reduce": 0, "all_to_all": 0,
        "ppermute_elems": []}


def test_a_norm_is_the_only_all_reduce():
    img = np.random.default_rng(2).random((128, 64)).astype(np.float32)
    for plan in (ShardedWavelets(img, "db2", 2, mesh=_mesh(1, 8)),
                 BatchedWavelets(np.stack([img] * 4), "db2", 2,
                                 mesh=_mesh(4, 1)),
                 BatchedWavelets(np.stack([img] * 4), "db2", 2,
                                 mesh=_mesh(2, 4))):
        plan.forward()
        for norm in (plan.norm1, plan.norm2sq):
            plan.ring.reset()
            assert norm() > 0
            assert audit.schedule_of(plan.ring) == {
                "ppermute": 0, "all_gather": 0, "all_reduce": 1,
                "all_to_all": 0, "ppermute_elems": []}
    parts = pring.shard_rows(torch.from_numpy(np.stack([img] * 4)),
                             _mesh(4, 1))
    from pypwt_tpu_torch.parallel import batch
    ring = pring.LocalRing([CPU] * 4, 1)
    n1, n2 = batch.norms_batched(batch.wavedec2_batched(
        parts, get_filter_bank("db2"), 2, _mesh(4, 1)), ring)
    assert ring.counts["all_reduce"] == 2 and float(n1) > 0 < float(n2)


WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    from pypwt_tpu_torch import get_filter_bank
    from pypwt_tpu_torch.parallel import ring as pring, spatial
    rank, world = int(sys.argv[1]), 4
    dist.init_process_group("gloo", init_method={init!r}, world_size=world,
                            rank=rank)
    ring = pring.ProcessGroupRing()
    x = np.random.default_rng(5).random((64, 64))
    mine = [torch.from_numpy(np.ascontiguousarray(
        np.array_split(x, world, 0)[rank]))]
    out = {{}}
    for tag, wname, levels, swt in (("dwt", "db2", 2, False),
                                    ("swt", "db3", 4, True)):
        fb = get_filter_bank(wname)
        if swt:
            pyr = spatial.swt2d_rowsharded(mine, fb, levels, None, ring)
            back = spatial.iswt2d_rowsharded(pyr, fb, None, ring=ring)
        else:
            pyr = spatial.wavedec2_rowsharded(mine, fb, levels, None, ring)
            back = spatial.waverec2_rowsharded(pyr, fb, None, ring=ring)
        leaves = [pyr[0]] + [s for lev in pyr[1:] for s in lev]
        for k, leaf in enumerate(leaves):
            out[f"{{tag}}{{k}}"] = leaf[0].numpy()
        out[f"{{tag}}back"] = back[0].numpy()
    out["norm"] = ring.all_reduce_sum(
        [mine[0].abs().sum()]).numpy()
    out["counts"] = np.array([ring.counts["ppermute"]])
    # a 2 x 2 grid, rank i * 2 + j holding block (i, j)
    rings = pring.ProcessGroupRing.grid(2, 2)
    i, j = divmod(rank, 2)
    blk = [torch.from_numpy(np.ascontiguousarray(x[32 * i:32 * i + 32,
                                                   32 * j:32 * j + 32]))]
    fb = get_filter_bank("db3")
    for tag, fwd, inv in (("grid", spatial.wavedec2_gridsharded,
                           spatial.waverec2_gridsharded),
                          ("gswt", spatial.swt2d_gridsharded,
                           spatial.iswt2d_gridsharded)):
        pyr = fwd(blk, fb, 2, None, rings)
        back = inv(pyr, fb, None, rings)
        leaves = [pyr[0]] + [s for lev in pyr[1:] for s in lev]
        for k, leaf in enumerate(leaves):
            out[f"{{tag}}{{k}}"] = leaf[0].numpy()
        out[f"{{tag}}back"] = back[0].numpy()
    out["gridcounts"] = np.array([rings.counts["ppermute"]])
    # a signal over the 4 ranks
    sig = np.random.default_rng(6).random(1024)
    seg = [torch.from_numpy(np.ascontiguousarray(
        np.array_split(sig, world)[rank]))]
    ring = pring.ProcessGroupRing()
    pyr = spatial.wavedec1_seqsharded(seg, fb, 3, None, ring)
    back = spatial.waverec1_seqsharded(pyr, fb, None, ring)
    for k, leaf in enumerate(pyr):
        out[f"seq{{k}}"] = leaf[0].numpy()
    out["seqback"] = back[0].numpy()
    out["seqcounts"] = np.array([ring.counts["ppermute"]])
    np.savez({out!r} + f"/rank{{rank}}.npz", **out)
    dist.destroy_process_group()
""")


def test_process_group_ring_equals_local_ring(tmp_path):
    """4 gloo processes (a file rendezvous, no port), one shard each:
    the db2 L2 DWT roundtrip and the db3 L4 SWT, whose (16, 24)-row halos
    take two hops on 16-row shards, equal the LocalRing results bit for
    bit, with the same exchange counts."""
    code = WORKER.format(repo=os.path.abspath(REPO),
                         init=f"file://{tmp_path}/rendezvous",
                         out=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]
    x = np.random.default_rng(5).random((64, 64))
    m = _mesh(1, 4)
    counts = 0
    for tag, wname, levels, swt in (("dwt", "db2", 2, False),
                                    ("swt", "db3", 4, True)):
        fb = get_filter_bank(wname)
        ring = pring.LocalRing([CPU] * 4, 4)
        if swt:
            pyr = spatial.swt2d_rowsharded(x, fb, levels, m, ring)
            back = spatial.iswt2d_rowsharded(pyr, fb, m, ring=ring)
        else:
            pyr = spatial.wavedec2_rowsharded(x, fb, levels, m, ring)
            back = spatial.waverec2_rowsharded(pyr, fb, m, ring=ring)
        counts += ring.counts["ppermute"]
        leaves = [pyr[0]] + [s for lev in pyr[1:] for s in lev]
        for r in range(4):
            got = np.load(tmp_path / f"rank{r}.npz")
            for k, leaf in enumerate(leaves):
                np.testing.assert_array_equal(got[f"{tag}{k}"],
                                              leaf[r].numpy())
            np.testing.assert_array_equal(got[f"{tag}back"],
                                          back[r].numpy())
    for r in range(4):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert int(got["counts"][0]) == counts
        np.testing.assert_allclose(float(got["norm"]), np.abs(x).sum(),
                                   rtol=1e-12)
    # the grid and the signal: bit-equal to LocalRing, the same counts
    fb = get_filter_bank("db3")
    m = pmesh.make_mesh2d(2, 2, [CPU] * 4)
    rings = pring.GridRings.for_mesh(m)
    for tag, fwd, inv in (("grid", spatial.wavedec2_gridsharded,
                           spatial.waverec2_gridsharded),
                          ("gswt", spatial.swt2d_gridsharded,
                           spatial.iswt2d_gridsharded)):
        pyr = fwd(x, fb, 2, m, rings)
        back = inv(pyr, fb, m, rings)
        leaves = [pyr[0]] + [s for lev in pyr[1:] for s in lev]
        for r in range(4):
            got = np.load(tmp_path / f"rank{r}.npz")
            for k, leaf in enumerate(leaves):
                np.testing.assert_array_equal(got[f"{tag}{k}"],
                                              leaf[r].numpy())
            np.testing.assert_array_equal(got[f"{tag}back"],
                                          back[r].numpy())
    sig = np.random.default_rng(6).random(1024)
    ring = pring.LocalRing([CPU] * 4, 4)
    pyr = spatial.wavedec1_seqsharded(sig, fb, 3, _mesh(1, 4), ring)
    back = spatial.waverec1_seqsharded(pyr, fb, _mesh(1, 4), ring)
    for r in range(4):
        got = np.load(tmp_path / f"rank{r}.npz")
        for k, leaf in enumerate(pyr):
            np.testing.assert_array_equal(got[f"seq{k}"], leaf[r].numpy())
        np.testing.assert_array_equal(got["seqback"], back[r].numpy())
        # one ppermute per exchange, on each rank as on the local rings
        assert int(got["gridcounts"][0]) == rings.counts["ppermute"]
        assert int(got["seqcounts"][0]) == ring.counts["ppermute"]
