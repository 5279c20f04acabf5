"""SeamlessM4T-medium and InternVL2-2B on a data × model mesh, held
against the JAX package on ``make_test_mesh()`` (2 × 4): the reference
on 8 emulated devices (a subprocess), the port on 8 gloo processes with
the reference's weights (``tests/_mesh_models.py``), both with the same
seeded frontend embeddings.

* Per-rank weight slices equal the reference's bit for bit — the
  encoder's attention on the decoder's ``heads_sub × cluster`` factoring
  with the encoder's heads, the cross-attention as the decoder's
  attention, ``frontend_proj`` replicated — at head-parallel and at a
  cluster of 2; a rank's seeded init equals the model's init sliced.
* The f32 forward: hidden states to 2e-5, the last position's greedy
  tokens equal (InternVL2 also at a cluster of 2); InternVL2 with a
  vocabulary of 510 (padded to 512 over the 4 ranks, the padded rows
  zeros and not masked, as the reference's): the head's 8 candidates,
  padded ids included, equal the reference's top 8 over its padded
  vocabulary.
* Lockstep engines on both backends (the reference's ``"pallas"`` in
  interpret mode) at the reference's pick, and InternVL2 also at
  ``EngineOptions(cluster=2)``; prefill (InternVL2's splice of the 16
  patch positions, SeamlessM4T's encoder and ``enc_kv`` at the rank's
  kv heads) and teacher-forced decode in bf16, tokens on ≥ 0.9 of
  (step, slot) and every difference a near-tie; each rank's state sized
  as the reference's; ``generate`` with the frontend embeddings on the
  mesh from a fresh state.
* ``serving_layout`` against the reference's picks.
"""
import numpy as np
import pytest

import _mesh_models as mm

pytestmark = pytest.mark.multidevice

MODELS = {"seamless-m4t-medium": ({}, {}), "internvl2-2b": ({}, {})}
CLUSTERS = {"internvl2-2b": (2,)}
ENGINES = mm.engine_cases(MODELS, CLUSTERS)
FORWARD = mm.forward_cases(MODELS, CLUSTERS)
PADDED = "internvl2-2b-v510-c1"
FORWARD[PADDED] = dict(arch="internvl2-2b", cluster=1, reduced={},
                       replace=dict(vocab_size=510))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return mm.run_models(tmp_path_factory.mktemp("mesh_modality"), ENGINES,
                         FORWARD)


@pytest.mark.parametrize("key", sorted(ENGINES))
def test_engine_on_mesh_matches_reference(results, key):
    mm.check_engine(results, key)


@pytest.mark.parametrize("key", sorted(FORWARD))
def test_forward_f32_on_mesh_matches_reference(results, key):
    mm.check_forward(results, key)


def test_padded_vocabulary_candidates_match_reference(results):
    """The merged top 8 over the padded vocabulary (ids 510 and 511 are
    zero rows of the last rank's shard) against the reference's hidden
    states through its padded head table, in f64."""
    h_ref = results["ref"]["forward"][PADDED]["hidden"]
    table = results["fwd"][PADDED]["lm_head"]
    table = np.asarray(table, np.float64).reshape(-1, table.shape[-1])
    assert table.shape[0] == 512 and not table[510:].any()
    for rank in range(8):
        d = rank // 4
        logits = h_ref[2 * d:2 * d + 2, -1].astype(np.float64) @ table.T
        want = np.argsort(-logits, axis=-1, kind="stable")[:, :8]
        np.testing.assert_array_equal(
            results["port"][rank]["forward"][PADDED]["cands"], want)


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
