"""The port's cluster collectives over ``torch.distributed``
(``src/repro_torch/core/primitives.py``) held against the JAX package's
(``repro/core/primitives.py``): the same rows through both, the
reference on 8 emulated devices (a subprocess), the port on 8 gloo
processes, on the model axis of a 2 × 4 mesh and on the heads 2 ×
cluster 4 sub-axes of an 8-rank line.

The model code's :class:`ParallelCtx` (``models/ctx.py``) is held the
same way on the 8-rank line, factored as heads 2 × cluster 4 and as
heads 8 × cluster 1 (``make_train_ctx``): its reduces, its gather and
its indices.

Tolerances: the trees (ClusterReduce sum/max/min, the pairs form,
ClusterGather) fix the order of every operation, so their f32 results
equal the reference's bit for bit.  The flash merge takes ``exp``, which
XLA and torch compute each in their own way: within 4 f32 epsilons of
each value and of the largest (an ``o`` that cancels to near zero keeps
the rounding of its terms).  The
backend's all-reduce (``dist.all_reduce``, the reference's ``lax.psum``)
sums in its own order: to 1e-6 relative.
"""
import json
import pickle

import numpy as np
import pytest

from _mesh_ranks import run_ranks
from helpers import run_multidevice

from repro_torch.core import primitives as prim

pytestmark = pytest.mark.multidevice

REF_BODY = """
import pickle
from repro.core import primitives as prim
from repro.launch.mesh import make_test_mesh
from repro.models.ctx import make_train_ctx
data = pickle.load(open({inp!r}, "rb"))
arrs = [jnp.asarray(data[k]) for k in "xmlo"]
mesh = make_test_mesh()
line = jax.make_mesh((8,), ("c",), axis_types=(jax.sharding.AxisType.Auto,))
flat2, flat1 = P(("data", "model")), P("c")

def run(m, spec, fn):
    body = lambda *a: jax.tree.map(lambda t: t[None],
                                   fn(*[t[0] for t in a]))
    f = shard_map(body, mesh=m, in_specs=(spec,) * 4, out_specs=spec,
                  check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(f)(*arrs))

axes = {{"model": (mesh, flat2, "model"),
        "heads": (line, flat1, prim.SubAxis("c", 2, minor_size=4)),
        "clus": (line, flat1, prim.SubAxis("c", 4, minor_size=1))}}
out = {{}}
for name, (m, spec, ax) in axes.items():
    for op in ("sum", "max", "min"):
        out[f"{{name}}/reduce_{{op}}"] = run(
            m, spec, lambda x, *_: prim.cluster_reduce(x, ax, op))
    out[f"{{name}}/gather"] = run(
        m, spec, lambda x, *_: prim.cluster_gather(x, ax))
    out[f"{{name}}/gather_tiled1"] = run(
        m, spec, lambda x, *_: prim.cluster_gather_tiled(x, ax, axis=1))
    out[f"{{name}}/pairs"] = run(
        m, spec, lambda x, mm, ll, oo: prim.cluster_reduce_pairs(
            (mm, ll, oo), ax, prim.flash_merge))
    for fused in (True, False):
        out[f"{{name}}/flash_{{fused}}"] = run(
            m, spec, lambda x, mm, ll, oo: prim.cluster_flash_combine(
                mm, ll, oo, ax, fused=fused))
out["model/xla_sum"] = run(mesh, flat2,
                           lambda x, *_: prim.cluster_reduce_xla(x, "model"))
out["model/xla_max"] = run(mesh, flat2, lambda x, *_: prim.cluster_reduce_xla(
    x, "model", "max"))
out["model/xla_gather"] = run(mesh, flat2, lambda x, *_: prim.cluster_gather_xla(
    x, "model", axis=1))
out["model/offchip_sum"] = run(mesh, flat2,
                               lambda x, *_: prim.offchip_reduce(x, "model"))
out["model/offchip_max"] = run(mesh, flat2, lambda x, *_: prim.offchip_reduce(
    x, "model", "max"))
for hs in (2, 8):
    c = make_train_ctx("c", heads_sub=hs, model_size=8, data=())
    out[f"ctx{{hs}}/psum_model"] = run(line, flat1,
                                       lambda x, *_: c.psum_model(x))
    out[f"ctx{{hs}}/psum_heads"] = run(line, flat1,
                                       lambda x, *_: c.psum_heads(x))
    out[f"ctx{{hs}}/gather_cluster"] = run(
        line, flat1, lambda x, *_: c.gather_cluster(x, 1))
    out[f"ctx{{hs}}/reduce_cluster_max"] = run(
        line, flat1, lambda x, *_: c.reduce_cluster(x, "max"))
    out[f"ctx{{hs}}/index"] = run(line, flat1, lambda *_: jnp.stack(
        [c.heads_index(), c.cluster_index(), c.model_index()]).astype(
            jnp.int32))
pickle.dump(out, open({out!r}, "wb"))
print("REF OK")
"""

EXACT = ("reduce_sum", "reduce_max", "reduce_min", "gather", "gather_tiled1")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prims")
    rng = np.random.default_rng(0)
    data = {"x": rng.standard_normal((8, 3, 5)).astype(np.float32),
            "m": rng.standard_normal((8, 2, 3)).astype(np.float32),
            "l": rng.uniform(0.5, 2.0, (8, 2, 3)).astype(np.float32),
            "o": rng.standard_normal((8, 2, 3, 4)).astype(np.float32)}
    inp, out = tmp / "in.pkl", tmp / "ref.pkl"
    with open(inp, "wb") as f:
        pickle.dump(data, f)
    run_multidevice(REF_BODY.format(inp=str(inp), out=str(out)), timeout=300)
    with open(out, "rb") as f:
        ref = pickle.load(f)
    port = run_ranks("_mesh_ranks:primitives_body", 8, tmp, data,
                     timeout=240)
    return ref, port


def _leaves(t):
    return list(t) if isinstance(t, tuple) else [t]


@pytest.mark.parametrize("axis", ["model", "heads", "clus"])
@pytest.mark.parametrize("prim_name", ["reduce_sum", "reduce_max",
                                       "reduce_min", "gather",
                                       "gather_tiled1", "pairs",
                                       "flash_True", "flash_False"])
def test_tree_primitive_matches_reference(results, axis, prim_name):
    ref, port = results
    key = f"{axis}/{prim_name}"
    for rank in range(8):
        for want, got in zip(_leaves(ref[key]), _leaves(port[rank][key])):
            want = want[rank]
            assert got.shape == want.shape, (key, rank)
            if prim_name in EXACT:
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                tol = 4 * np.finfo(np.float32).eps
                np.testing.assert_allclose(
                    got, want, rtol=tol, atol=tol * np.abs(want).max(),
                    err_msg=key)


@pytest.mark.parametrize("prim_name", ["xla_sum", "xla_max", "xla_gather",
                                       "offchip_sum", "offchip_max"])
def test_backend_collective_matches_reference(results, prim_name):
    ref, port = results
    key = f"model/{prim_name}"
    for rank in range(8):
        np.testing.assert_allclose(port[rank][key], ref[key][rank],
                                   rtol=1e-6, atol=1e-6, err_msg=key)


# the ctx methods that run the backend's all-reduce: psum_model on the
# whole axis, and psum_heads where heads span it at cluster 1 (hs 8)
CTX_ALL_REDUCE = ("ctx2/psum_model", "ctx8/psum_model", "ctx8/psum_heads")


@pytest.mark.parametrize("hs", [2, 8])
@pytest.mark.parametrize("method", ["psum_model", "psum_heads",
                                    "gather_cluster", "reduce_cluster_max",
                                    "index"])
def test_parallel_ctx_matches_reference(results, hs, method):
    """``ParallelCtx`` on the 8-rank line: the trees (``psum_heads`` over
    2 head ranks, the cluster's gather and max) and the indices bit for
    bit, the backend's all-reduce to 1e-6 (module docstring)."""
    ref, port = results
    key = f"ctx{hs}/{method}"
    for rank in range(8):
        got, want = port[rank][key], ref[key][rank]
        assert np.shape(got) == want.shape, (key, rank)
        if key in CTX_ALL_REDUCE:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_every_rank_of_a_group_holds_the_same_sum(results):
    """The tree's sum is the reference's on each rank; ranks of one group
    may differ in the last bit (each adds in its own ring order), and
    the backend's all-reduce gives every rank the same bits."""
    _, port = results
    for g in range(2):
        got = [port[r]["model/xla_sum"] for r in range(4 * g, 4 * g + 4)]
        assert all(np.array_equal(got[0], v) for v in got[1:])


def test_traffic_model_matches_the_reference():
    from repro.core import primitives as ref
    for size, n in ((10, 4), (7, 8), (3, 16), (5, 1)):
        assert prim.traffic_reduce(size, n) == ref.traffic_reduce(size, n)
        assert prim.traffic_gather(size, n) == ref.traffic_gather(size, n)


def test_size_one_moves_nothing_and_other_sizes_raise():
    """An axis of one returns its input without a collective (no world
    is initialised here); a tree over an axis that is not a power of two
    raises before any send, as the reference does."""
    import torch
    one = prim.MeshAxis("model", (0,), 0)
    x = torch.arange(6.0).reshape(2, 3)
    assert prim.cluster_reduce(x, one) is x
    assert prim.cluster_reduce_pairs((x, x), one, prim.flash_merge)[0] is x
    assert prim.cluster_gather(x, one).shape == (1, 2, 3)
    assert prim.cluster_gather_tiled(x, one, 1) is x
    assert prim.cluster_reduce_xla(x, one) is x
    three = prim.MeshAxis("model", (0, 1, 2), 0)
    for fn in (lambda: prim.cluster_reduce(x, three),
               lambda: prim.cluster_gather(x, three),
               lambda: prim.cluster_reduce(
                   x, prim.SubAxis(prim.MeshAxis("m", tuple(range(6)), 0), 3,
                                   minor_size=2))):
        with pytest.raises(ValueError, match="2\\*\\*k"):
            fn()
    # the sub-axis send pattern pairs only ranks of one logical group
    line = prim.MeshAxis("model", tuple(range(8)), 0)
    heads = prim.SubAxis(line, 2, minor_size=4)
    assert prim._ring_perm(heads, 1) == [(r, (r + 4) % 8) for r in range(8)]
    clus = prim.SubAxis(line, 4, minor_size=1)
    assert prim._ring_perm(clus, 2) == [
        (r, r - r % 4 + (r % 4 + 2) % 4) for r in range(8)]
    assert json.dumps(prim._ring_perm(line, 1)) == json.dumps(
        [[b, (b + 1) % 8] for b in range(8)])
