"""The exchange schedule of the port's row-sharded path, counted on its
own exchange layer (``parallel.ring``) and held against the analytic
prediction (``parallel.audit.predict_rowsharded``) and against JAX's
(``pypwt_tpu.parallel.audit``), which reads the same schedule from
compiled HLO: per level halo-sized ring exchanges only, no all-gather or
all-to-all, one all-reduce per norm, the same counts and per-shard halo
bytes on rings of any size.  Last, ``ProcessGroupRing`` on 4 gloo
processes gives exactly the results of ``LocalRing``.
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
