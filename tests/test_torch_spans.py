"""The port's span recorder (``repro_torch.spans``) on one training step
of a small dense model (2 layers, d 64): off, it records nothing and
hands tensors back untouched; on, the step's numbers are bit-equal to
off, and the spans nest as the step runs, with the bytes AdamW moves."""
import sys
import threading

import pytest
import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import build_model
from repro_torch.optim import clip
from repro_torch.train.step import init_state, make_train_step

CFG = ModelConfig(name="granite-3-2b", family="dense", n_layers=2,
                  d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                  d_ff=128, vocab_size=500, tie_embeddings=True)
B, S = 2, 24


def _batch():
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, CFG.vocab_size, (B, S), generator=g)
    return {"tokens": tokens, "labels": tokens}


def _model():
    model = build_model(CFG, device="cpu", seed=3)
    with torch.no_grad():     # norms away from their zero init
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator(
                    ).manual_seed(len(name))))
    return model


def _one_step(monkeypatch, record: bool):
    """(metrics, gradients as clip got them, parameters, moments, records)
    after one step from the same weights."""
    model = _model()
    rc = RunConfig(warmup_steps=1)
    state = init_state(model, rc)
    step = make_train_step(model, rc, total_steps=10)
    seen = {}
    orig = clip.clip_by_global_norm

    def keep(tree, max_norm):
        seen.update({k: g.clone() for k, g in tree.items()})
        return orig(tree, max_norm)

    monkeypatch.setattr(clip, "clip_by_global_norm", keep)
    records = None
    if record:
        with spans.recording() as records:
            state, m = step(state, _batch())
    else:
        state, m = step(state, _batch())
    monkeypatch.setattr(clip, "clip_by_global_norm", orig)
    return m, seen, state, records


def _graph_names(t):
    names, todo, seen = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_off_records_nothing_and_hands_tensors_back():
    a, b = torch.ones(3, requires_grad=True), torch.zeros(2)
    s = spans.span("attn")
    assert s is spans.span("ffn") and not s.on
    with s as t:
        assert t.inputs(a) is a and t.output(b) is b
        x, y = t.inputs(a, b)
        assert x is a and y is b
    model = _model()
    loss, _ = model.loss(_batch())
    assert spans._recorder is None
    assert not any("Backward" in n and n.startswith("_")
                   for n in _graph_names(loss))
    with spans.recording() as records:
        assert records == []
        loss_on, _ = model.loss(_batch())
    assert {"_OpensBackwardBackward", "_ClosesBackwardBackward"} <= \
        _graph_names(loss_on)
    assert torch.equal(loss, loss_on)


def test_a_step_is_bit_equal_with_recording_on_and_off(monkeypatch):
    m0, g0, s0, _ = _one_step(monkeypatch, record=False)
    m1, g1, s1, records = _one_step(monkeypatch, record=True)
    assert records
    for k in ("loss", "grad_norm"):
        assert torch.equal(m0[k], m1[k]), k
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
        assert torch.equal(s0.params[k], s1.params[k]), k
        assert torch.equal(s0.opt.mu[k], s1.opt.mu[k]), k
        assert torch.equal(s0.opt.nu[k], s1.opt.nu[k]), k


def _children(records, parent):
    return sorted((r for r in records if r.parent == parent.id),
                  key=lambda r: r.start)


def test_one_step_nests_its_spans_and_counts_its_work(monkeypatch):
    _, _, state, records = _one_step(monkeypatch, record=True)
    assert all(r.end is not None and r.start <= r.end for r in records)
    # boundaries numbered in the order they were crossed
    assert sorted(m for r in records for m in (r.start_mark, r.end_mark)) \
        == list(range(2 * len(records)))
    by_id = {r.id: r for r in records}
    for r in records:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_mark < r.start_mark < r.end_mark < p.end_mark
    (step,) = [r for r in records if r.parent is None]
    assert step.name == "train.step" and step.counts == {}
    assert all(r.step == step.id for r in records)
    fwd, bwd, clp, opt = _children(records, step)
    assert [fwd.name, bwd.name, clp.name, opt.name] == [
        "train.forward", "train.backward", "optim.clip", "optim.adamw"]
    # forward in layer order, backward last layer first
    assert [r.name for r in _children(records, fwd)] == \
        ["embed"] + ["attn", "ffn"] * CFG.n_layers + ["head", "head"]
    back = _children(records, bwd)
    assert [r.name for r in back] == \
        ["head", "head"] + ["ffn", "attn"] * CFG.n_layers + ["embed"]
    assert all(bwd.start <= r.start and r.end <= bwd.end for r in back)
    for r in _children(records, fwd) + back:
        kids = [c.name for c in _children(records, r)]
        assert kids == (["attn.scores"] if r.name == "attn" else []), r.name
    assert sum(r.name == "attn.scores" for r in records) == 2 * CFG.n_layers
    elements = sum(p.numel() for p in state.params.values())
    assert clp.counts == {}
    assert opt.counts == {"bytes": 28 * elements}


def test_on_a_card_each_boundary_queries_the_stream(monkeypatch):
    class Stream:
        queries = 0

        def query(self):
            Stream.queries += 1
            return True

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    _, _, _, records = _one_step(monkeypatch, record=True)
    assert Stream.queries == 2 * len(records) > 0


def test_recording_twice_at_once_raises():
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert spans._recorder is None


def test_spans_from_many_threads_are_all_kept():
    """Autograd records backward spans from a thread of its own: records
    made from threads at once are neither lost nor left open."""
    n_threads, n = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.recording() as records:
            def work():
                for _ in range(n):
                    with spans.span("outer"):
                        with spans.span("inner"):
                            pass
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert spans._recorder.open == []
    finally:
        sys.setswitchinterval(old)
    assert len(records) == 2 * n_threads * n
    assert len({r.id for r in records}) == len(records)
    assert all(r.end is not None for r in records)
