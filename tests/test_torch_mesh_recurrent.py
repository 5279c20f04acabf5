"""RWKV-6 3B and RecurrentGemma-9B on a data × model mesh, held against
the JAX package on ``make_test_mesh()`` (2 × 4): the reference on 8
emulated devices (a subprocess), the port on 8 gloo processes with the
reference's weights (``tests/_mesh_models.py``).

* Per-rank weight slices equal the reference's bit for bit — RG-LRU's
  ``d_state / ms`` channels (its gate blocks whole), RWKV-6's heads over
  ``heads_sub`` and its channel mix's ``d_ff`` — at head-parallel and at
  a cluster of 2; a rank's seeded init equals the model's init sliced.
* The f32 forward: hidden states to 2e-5, the last position's greedy
  tokens equal (RecurrentGemma also at a cluster of 2: its local layers
  split their query blocks over the cluster).
* Lockstep engines on both backends (the reference's ``"pallas"`` in
  interpret mode) at the reference's pick, and RecurrentGemma also at
  ``EngineOptions(cluster=2)``: its ring of 8 slots (``sliding_window``
  8 on both sides, 5 layers so the two RG-LRU tail layers exist) split 4
  a rank and wrapped by the 16-token prompt; prefill and teacher-forced
  decode in bf16, tokens on ≥ 0.9 of (step, slot) and every difference
  a near-tie; each rank's state sized as the reference's; ``generate``
  on the mesh from a fresh state; a prompt one token short (prefill
  pads it to the cluster's query blocks, the recurrent layers keep the
  padding out of their states) at cluster 2 against the pick.
* ``serving_layout`` against the reference's picks, and ``"auto"``'s
  backend and prepack on a model axis against ``tune_serving``'s.
"""
import pytest

import _mesh_models as mm

pytestmark = pytest.mark.multidevice

MODELS = {"rwkv6-3b": ({}, {}),
          "recurrentgemma-9b": (dict(n_layers=5), dict(sliding_window=8))}
CLUSTERS = {"recurrentgemma-9b": (2,)}
ENGINES = mm.engine_cases(MODELS, CLUSTERS, odd=("recurrentgemma-9b",))
FORWARD = mm.forward_cases(MODELS, CLUSTERS)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return mm.run_models(tmp_path_factory.mktemp("mesh_recurrent"), ENGINES,
                         FORWARD)


@pytest.mark.parametrize("key", sorted(ENGINES))
def test_engine_on_mesh_matches_reference(results, key):
    mm.check_engine(results, key)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_odd_prompt_at_cluster_2_keeps_padding_out_of_the_state(results,
                                                                backend):
    mm.check_odd_prompt(results, f"recurrentgemma-9b-{backend}-pick",
                        f"recurrentgemma-9b-{backend}-c2")


@pytest.mark.parametrize("key", sorted(FORWARD))
def test_forward_f32_on_mesh_matches_reference(results, key):
    mm.check_forward(results, key)


@pytest.mark.parametrize("hs", [4, 2])
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_device_major_slices_match_reference(arch, hs):
    mm.check_slices(arch, hs, *MODELS[arch])


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_seeded_init_of_a_rank_is_the_model_sliced(arch):
    mm.check_seeded_init(arch, 2, *MODELS[arch])


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_serving_layout_matches_reference_pick(arch):
    mm.check_layout(arch)


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_backend_and_prepack_on_a_model_axis_match_reference(arch, tmp_path):
    """``"auto"`` on a model axis of 4 resolves as the reference's
    ``tune_serving`` does: attention-free RWKV-6 to ``"xla"`` and never a
    prepack (reference ``tests/test_prepack.py:388–391``),
    RecurrentGemma (local attention layers) to ``"pallas"`` with the
    serve layout."""
    from repro.core.autotune import tune_serving
    from repro_torch.core.autotune import resolve_serving
    ref_cfg, cfg = mm.cfgs(arch, *MODELS[arch])
    want = tune_serving(ref_cfg, seq_len=512, batch=2, model_axis=4,
                        backend="auto", table_path=str(tmp_path / "t.json"))
    got = resolve_serving(cfg, "auto", "auto")
    assert got == (want.backend, want.prepack)
    assert got == (("xla", False) if cfg.is_attention_free
                   else ("pallas", True))
