"""The decode step as one CUDA-graph replay (``serving/step_graph.py``)
held against the eager step, on the CPU at reduced size.

``torch.cuda.graph`` cannot run here, so the tests replace the module's
graph factory (``step_graph.capture_graph``) with a fake: at capture it
keeps the zero-argument step and runs it once, at every replay it runs
it again.  While the fake captures or replays, every call that would
break a real capture raises — ``torch.tensor``, ``torch.from_numpy``,
``torch.as_tensor`` of anything but a tensor, and a tensor's ``item``,
``tolist``, ``numpy``, ``cpu``, ``bool``, ``int`` and ``float`` — so a
new host sync or host-built tensor in the step fails here, as the real
capture (``capture_error_mode="global"``) fails on the card.

Graphed and eager engines are built from the same seed and must give
the same tokens and the same state bit for bit: on a staggered
``SlotScheduler`` trace on fused Llama (``"pallas"``), its dense-MLA
DeepSeek-V2-Lite arm and unfused Llama (``"xla"``), and on two
``generate`` batches on RWKV-6 and on RecurrentGemma's both backends.  One test holds the
graphed unfused engine against the JAX package's XLA engine on the same
weights, as ``tests/test_torch_xla_path.py`` holds the eager one.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import build_engine_full as ref_build
from repro.serving.engine import EngineOptions as RefOptions
from repro.serving.scheduler import Request as RefRequest
from repro.serving.scheduler import SlotScheduler as RefScheduler
from repro.serving.scheduler import replay_trace as ref_replay

from test_torch_layers import jax_tree_to_numpy

from repro_torch.configs import get_config, reduced
from repro_torch.core import tracecount
from repro_torch.kernels.fused_head.topk import select_topk
from repro_torch.launch.serve import build_engine_full, generate
from repro_torch.models.layers import rope_freqs
from repro_torch.models.transformer import embed_tokens, from_reference_params
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import step_graph
from repro_torch.serving.engine import EngineOptions, init_decode_state
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.scheduler import Request, SlotScheduler, replay_trace
from repro_torch.serving.step_graph import StepGraph

SLOTS, MAX_SEQ, PROMPT_CAP = 3, 48, 16
# arrival tick, prompt length, new tokens: the third request waits for a
# slot, which the first frees mid-run
TRACE = [(0, 5, 3), (0, 7, 8), (1, 4, 6), (2, 9, 5)]


class CaptureHazard(RuntimeError):
    """A call inside the step that a real CUDA-graph capture refuses."""


def _refuse(what):
    def refuse(*args, **kwargs):
        raise CaptureHazard(f"{what} inside a captured step")
    return refuse


@contextlib.contextmanager
def _capture_rules():
    """Make the calls that break a CUDA-graph capture raise."""
    as_tensor = torch.as_tensor

    def tensor_only(data, *args, **kwargs):
        if not torch.is_tensor(data):
            raise CaptureHazard("torch.as_tensor of host data inside a "
                                "captured step")
        return as_tensor(data, *args, **kwargs)

    patches = [(torch, "tensor", _refuse("torch.tensor")),
               (torch, "from_numpy", _refuse("torch.from_numpy")),
               (torch, "as_tensor", tensor_only)]
    patches += [(torch.Tensor, name, _refuse(f"Tensor.{name}"))
                for name in ("item", "tolist", "numpy", "cpu", "__bool__",
                             "__int__", "__float__")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


@pytest.fixture(autouse=True)
def fake_graphs(monkeypatch):
    """The graph factory's stand-in: run the step once under the capture
    rules, and replay it by running it again under the same rules.
    Yields the steps captured, in order."""
    captured = []

    def fake_capture(step, device, pool=None):
        captured.append(step)
        with _capture_rules():
            step()

        def replay():
            with _capture_rules():
                step()
        return replay

    monkeypatch.setattr(step_graph, "capture_graph", fake_capture)
    return captured


def _config(arch):
    cfg = reduced(get_config(arch), n_layers=5 if arch == "recurrentgemma-9b"
                  else 0)
    return dataclasses.replace(cfg, moe=None) if cfg.moe else cfg


def _engines(arch, backend, *, check_finite=False, max_seq=MAX_SEQ,
             train=None):
    """(eager, graphed) engines on the CPU with the same weights."""
    cfg = _config(arch)
    opts = EngineOptions(backend=backend, check_finite=check_finite)
    eager, graphed = (build_engine_full(cfg, max_seq=max_seq,
                                        batch_global=SLOTS, device="cpu",
                                        seed=0, options=opts,
                                        train_params=train)
                      for _ in range(2))
    graph = StepGraph(cfg, graphed.scfg, graphed.params["serve"],
                      graphed.state)
    return eager, graphed._replace(decode_fn=graph)


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [t for sub in tree for t in _leaves(sub)]


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _assert_same_bits(a, b):
    """Every leaf the same dtype, shape and bytes (so bf16/f32 -0.0 and
    0.0 differ)."""
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def _trace(eng, vocab, sampled=False):
    """``TRACE`` through a fresh scheduler; ``sampled``: its even requests
    at temperature 0.8 (top-k 5, top-p 0.9, a seed each)."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).tolist() for _, n, _ in TRACE]
    sched = SlotScheduler(eng, prompt_cap=PROMPT_CAP)
    res = replay_trace(sched, [(a, Request(i, prompts[i], m, sampling=(
        SamplingParams(temperature=0.8, top_k=5, top_p=0.9, seed=i)
        if sampled and i % 2 == 0 else GREEDY)))
        for i, (a, _, m) in enumerate(TRACE)])
    return sched, res


@pytest.mark.parametrize("arch,backend,check_finite", [
    ("llama2-7b", "pallas", True), ("deepseek-v2-lite", "pallas", False),
    ("llama2-7b", "xla", False)])
def test_graphed_trace_equals_eager(arch, backend, check_finite,
                                    fake_graphs):
    """Staggered requests through ``SlotScheduler``: admits, a retire
    mid-run and a re-admit copy new small leaves into the graph's
    buffers; every decode step is one replay of the one graph captured;
    tokens, events and the final state equal the eager engine's bit for
    bit."""
    eager, graphed = _engines(arch, backend, check_finite=check_finite)
    assert len(fake_graphs) == 2     # greedy and sampled; the eager has none
    launches = dict(graphed.decode_fn.launches)
    e_sched, e_res = _trace(eager, eager.cfg.vocab_size)
    tracecount.reset()
    g_sched, g_res = _trace(graphed, graphed.cfg.vocab_size)
    assert g_sched.events == e_sched.events
    readmitted = [s for _, k, _, s in g_sched.events if k == "admit"]
    assert len(readmitted) > len(set(readmitted))       # a slot was reused
    assert {r: g_res[r].tokens for r in g_res} == \
        {r: e_res[r].tokens for r in e_res}
    assert graphed.decode_fn.replays == g_sched.decode_calls > 0
    assert tracecount.replays() == g_sched.decode_calls
    assert len(fake_graphs) == 2                          # no re-capture
    assert graphed.decode_fn.launches == launches
    _assert_same_bits(g_sched.state, e_sched.state)


@pytest.mark.parametrize("arch,backend,batches", [
    ("rwkv6-3b", "pallas", ((10, 5), (12, 7))),
    # the second prompt wraps the 64-row ring of the local layer
    ("recurrentgemma-9b", "xla", ((10, 4), (70, 6))),
    ("recurrentgemma-9b", "pallas", ((10, 4), (70, 6)))])
def test_graphed_generate_equals_eager(arch, backend, batches):
    """Two lockstep ``generate`` batches on one engine: the same tokens
    and, at the end, the same state bit for bit."""
    eager, graphed = _engines(arch, backend, check_finite=True, max_seq=96)
    rng = np.random.default_rng(3)
    e_st, g_st = eager.state, graphed.state
    for n_prompt, n_new in batches:
        prompts = rng.integers(0, eager.cfg.vocab_size,
                               (SLOTS, n_prompt)).astype(np.int32)
        want, e_st = generate(eager.params, eager.prefill_fn,
                              eager.decode_fn, e_st, prompts, n_new)
        got, g_st = generate(graphed.params, graphed.prefill_fn,
                             graphed.decode_fn, g_st, prompts, n_new)
        assert torch.equal(got, want)
    assert graphed.decode_fn.replays == sum(n - 1 for _, n in batches)
    _assert_same_bits(g_st, e_st)


def test_graphed_trace_matches_the_reference():
    """The graphed unfused engine against the JAX package's XLA engine on
    the same weights and trace: events agree event for event and tokens
    on ≥ 0.9, the bar of ``tests/test_torch_xla_path.py`` (with these
    seeds all of them)."""
    cfg = ref_reduced(ref_get_config("llama2-7b"))
    ref = ref_build(cfg, make_test_mesh(data=1, model=1), max_seq=MAX_SEQ,
                    batch_global=SLOTS, options=RefOptions(backend="xla"))
    train = from_reference_params(
        _config("llama2-7b"), jax_tree_to_numpy(ref.params["train"]),
        device="cpu")
    _, graphed = _engines("llama2-7b", "xla", train=train)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for _, n, _ in TRACE]
    r_sched = RefScheduler(ref, prompt_cap=PROMPT_CAP)
    r_res = ref_replay(r_sched, [(a, RefRequest(i, prompts[i], m))
                                 for i, (a, _, m) in enumerate(TRACE)])
    g_sched, g_res = _trace(graphed, cfg.vocab_size)
    assert g_sched.events == r_sched.events
    got = np.concatenate([g_res[r].tokens for r in sorted(g_res)])
    want = np.concatenate([r_res[r].tokens for r in sorted(r_res)])
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.9, (got, want)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_graphed_sampled_trace_equals_eager(backend, fake_graphs):
    """Half the trace sampled: a step with a live sampled slot replays the
    sampled graph, the others the greedy one; tokens and the final state
    equal the eager engine's bit for bit, and the sampled streams are not
    the greedy ones."""
    eager, graphed = _engines("llama2-7b", backend, check_finite=True)
    assert len(fake_graphs) == 2
    runs = {"greedy": 0, "sampled": 0}
    graph = graphed.decode_fn

    def counted(p, st, tok, sampled=False):
        runs["sampled" if sampled else "greedy"] += 1
        return graph(p, st, tok, sampled=sampled)

    e_sched, e_res = _trace(eager, eager.cfg.vocab_size, sampled=True)
    g_sched, g_res = _trace(graphed._replace(decode_fn=counted),
                            graphed.cfg.vocab_size, sampled=True)
    assert g_sched.events == e_sched.events
    assert {r: g_res[r].tokens for r in g_res} == \
        {r: e_res[r].tokens for r in e_res}
    assert graph.replays == g_sched.decode_calls == sum(runs.values())
    assert runs["sampled"] > 0 and runs["greedy"] > 0
    _assert_same_bits(g_sched.state, e_sched.state)
    _, greedy = _trace(eager, eager.cfg.vocab_size)
    assert any(greedy[r].tokens != e_res[r].tokens for r in e_res
               if r % 2 == 0)
    assert all(greedy[r].tokens == e_res[r].tokens for r in e_res if r % 2)


def test_build_leaves_a_fresh_state():
    """The warm-up and capture steps leave no trace: after the graph is
    built the engine's state equals a fresh ``init_decode_state`` bit for
    bit, and its small leaves are the graph's input buffers."""
    cfg = _config("llama2-7b")
    eng = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                            device="cpu", seed=0,
                            options=EngineOptions(check_finite=True))
    tracecount.reset()
    graph = StepGraph(cfg, eng.scfg, eng.params["serve"], eng.state)
    # two warm-up steps and the capture of each of the two steps (greedy
    # and sampled): the step ran six times
    assert tracecount.calls()["flash_decode"] == 2 * 3 * cfg.n_layers
    assert tracecount.replays() == 0
    _assert_same_bits(eng.state, init_decode_state(cfg, eng.scfg,
                                                   device="cpu"))
    tok, st = graph(eng.params["serve"], eng.state,
                    np.zeros(SLOTS, np.int32))
    assert st["cache_lens"] is eng.state["cache_lens"]
    assert st["nonfinite"] is eng.state["nonfinite"]
    assert all(st["sampling"][k] is eng.state["sampling"][k]
               for k in st["sampling"])
    assert st["cache_lens"].tolist() == [1] * SLOTS


def test_foreign_params_state_or_tokens_raise():
    """The graph serves the params and the caches it was captured on and
    nothing else: no re-capture, no eager fall-back."""
    cfg = _config("llama2-7b")
    eng = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                            device="cpu", seed=0)
    graph = StepGraph(cfg, eng.scfg, eng.params["serve"], eng.state)
    other = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                              device="cpu", seed=1)
    tok = np.zeros(SLOTS, np.int32)
    with pytest.raises(ValueError, match="params"):
        graph(other.params["serve"], eng.state, tok)
    with pytest.raises(ValueError, match="caches or recurrent"):
        graph(eng.params["serve"], other.state, tok)
    with pytest.raises(ValueError, match="caches or recurrent"):
        graph(eng.params["serve"],
              init_decode_state(cfg, eng.scfg, device="cpu"), tok)
    with pytest.raises(ValueError, match="tokens of shape"):
        graph(eng.params["serve"], eng.state, np.zeros(SLOTS + 1, np.int32))
    assert graph.replays == 0


def test_cpu_engine_decodes_eagerly(fake_graphs):
    """On the CPU ``build_engine_full`` gives the eager step: nothing is
    captured and a step is no replay."""
    cfg = _config("llama2-7b")
    eng = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                            device="cpu")
    assert not isinstance(eng.decode_fn, StepGraph)
    tracecount.reset()
    tok, _ = eng.decode_fn(eng.params["serve"], eng.state,
                           np.zeros(SLOTS, np.int32))
    assert tok.shape == (SLOTS,)
    assert not fake_graphs and tracecount.replays() == 0
    assert tracecount.calls()["flash_decode"] == cfg.n_layers


def test_returned_tokens_survive_later_steps():
    """``generate`` stacks every step's tokens: a returned token tensor
    is a copy, not the graph's output buffer."""
    eager, graphed = _engines("llama2-7b", "xla")
    prompts = np.arange(SLOTS * 6, dtype=np.int32).reshape(SLOTS, 6)
    outs = []
    tok, st = graphed.prefill_fn(graphed.params["train"], graphed.state,
                                 prompts)
    for _ in range(4):
        tok, st = graphed.decode_fn(graphed.params["serve"], st, tok)
        outs.append((tok, tok.clone()))
    assert all(torch.equal(t, kept) for t, kept in outs)
    want, _ = generate(eager.params, eager.prefill_fn, eager.decode_fn,
                       eager.state, prompts, 5)
    assert torch.equal(torch.stack([t for t, _ in outs], dim=-1),
                       want[:, 1:])


def test_fake_capture_catches_a_host_sync(monkeypatch):
    """A host read-back inside the step fails the capture, as on the
    card."""
    cfg = _config("llama2-7b")
    eng = build_engine_full(cfg, max_seq=MAX_SEQ, batch_global=SLOTS,
                            device="cpu", seed=0)
    real = engine_mod.finalize_candidates

    def syncing(vals, ids, samp, *noise):
        int(ids[0, 0])                    # a host read-back
        return real(vals, ids, samp, *noise)

    monkeypatch.setattr(engine_mod, "finalize_candidates", syncing)
    with pytest.raises(CaptureHazard, match="__int__"):
        StepGraph(cfg, eng.scfg, eng.params["serve"], eng.state)


def test_tracecount_replay_accounting():
    """Launches counted while a graph is captured go to that graph's
    count, not to ``launches()``; each replay credits them and counts
    itself; ``reset`` clears everything."""
    tracecount.reset()
    tracecount.launch("fused_ffn")
    with tracecount.capturing() as graph:
        tracecount.launch("fused_ffn")
        tracecount.launch("fused_head")
        with pytest.raises(RuntimeError, match="already"):
            with tracecount.capturing():
                pass
    assert graph["fused_ffn"] == graph["fused_head"] == 1
    assert tracecount.launches()["fused_ffn"] == 1
    assert tracecount.launches()["fused_head"] == 0
    for _ in range(3):
        tracecount.replayed(graph)
    assert tracecount.replays() == 3
    assert tracecount.launches()["fused_ffn"] == 4
    assert tracecount.launches()["fused_head"] == 3
    tracecount.launch("fused_head")            # eager again after capture
    assert tracecount.launches()["fused_head"] == 4
    tracecount.reset()
    assert tracecount.replays() == 0
    assert not any(tracecount.launches().values())


def test_scalar_sites_keep_their_bits():
    """The three scalars the step used to copy from the host are made on
    the device with the same bits: the tied-embedding scale (bf16
    √128 = 11.3125, √4096 = 64), the RoPE frequencies, and
    ``select_topk``'s index sentinel (ties go to the lowest index)."""
    for d, want in ((128, 11.3125), (4096, 64.0)):
        cfg = dataclasses.replace(_config("recurrentgemma-9b"), d_model=d)
        assert cfg.tie_embeddings
        table = torch.ones((4, d), dtype=torch.bfloat16)
        x = embed_tokens(cfg, table, torch.tensor([1, 3]))
        assert x.dtype == torch.bfloat16
        assert (x.float() == want).all()
    for hd, theta in ((128, 10000.0), (64, 500000.0), (256, 10000.0)):
        half = hd // 2
        want = torch.pow(torch.tensor(theta, dtype=torch.float32),
                         -torch.arange(half, dtype=torch.float32) / half)
        assert torch.equal(rope_freqs(hd, theta, "cpu").view(torch.int32),
                           want.view(torch.int32))
    vals = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 2.0]])
    ids = torch.tensor([[9, 7, 4, 1, 5, 0]], dtype=torch.int32)
    top_v, top_i = select_topk(vals, ids, 5)
    assert top_i.tolist() == [[4, 5, 7, 0, 1]]
    assert top_v.tolist() == [[3.0, 3.0, 3.0, 2.0, 2.0]]
