"""The port's LM examples (``examples/torch_serve_decode.py``,
``examples/torch_train_lm.py``) on the host (``--device cpu``).

Serving: the example against the reference's ``Engine`` run through the
same flow (8 requests from ``np.random.default_rng(0)``, a step after
each) on the example's weights, carried across with
``convert.lm_params_to_numpy``. Each request's stream equals the
reference's up to its first pick whose reference top-2 margin is under
``lm_parity.MARGIN`` (on these weights requests 1 and 4 each have one,
at ~8.7e-4 and ~8.3e-6: near-ties that either engine may break either
way), and whole where no such pick occurs. ``steps_run`` and
``active_history`` are equal whatever the picks: the requests carry no
eos id, so the schedule follows from the prompt lengths and budgets
alone.
Training: ``--fast`` runs whose loss falls, the second resuming from the
checkpoint the first wrote.
"""
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lm_parity as P
from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro.serve import Request as RefRequest
from repro_torch import convert

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module")
def examples():
    sys.path.insert(0, str(EXAMPLES))
    try:
        import torch_serve_decode
        import torch_train_lm
        yield types.SimpleNamespace(serve=torch_serve_decode,
                                    train=torch_train_lm)
    finally:
        sys.path.remove(str(EXAMPLES))


def test_serve_decode_equals_the_reference_engine(examples, capsys):
    eng, outs = examples.serve.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"served 8 requests in {eng.steps_run} decode steps"
    assert lines[1] == ("active-width history (the flexible-ISA analogue): "
                        f"{eng.active_history}")
    assert lines[2:] == [f"  req {rid}: {outs[rid]}" for rid in range(3)]

    cfg = ref_get_arch("granite-3-2b", smoke=True)
    params = jax.tree_util.tree_map(jnp.asarray, convert.lm_params_to_numpy(
        eng.model.cfg, eng.model.state_dict()))
    ref = MarginsByRequest(ref_build_model(cfg), params, max_slots=4,
                           capacity=128)
    rng = np.random.default_rng(0)
    for rid in range(8):
        ref.submit(RefRequest(rid=rid,
                              prompt=rng.integers(0, cfg.vocab_size,
                                                  int(rng.integers(4, 20))),
                              max_new_tokens=int(rng.integers(4, 12))))
        ref.step()
    ref_outs = ref.run_until_done()
    assert sorted(outs) == sorted(ref_outs) == list(range(8))
    for rid, want in ref_outs.items():
        margins = ref.margins_of[rid]
        assert len(margins) == len(want)
        clear = next((i for i, m in enumerate(margins) if m <= P.MARGIN),
                     len(want))
        assert len(outs[rid]) == len(want)
        assert outs[rid][:clear] == want[:clear], rid
    assert eng.steps_run == ref.steps_run
    assert eng.active_history == ref.active_history


class MarginsByRequest(P.RecordingEngine):
    """``lm_parity.RecordingEngine`` that also keeps each request's pick
    margins in order (``margins_of[rid]``): its prefill pick, then one for
    each decode step it was active in."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.margins_of: dict[int, list[float]] = {}
        prefill, decode = self._prefill, self._decode

        def by_request_prefill(params, toks):
            n = len(self.margins)
            out = prefill(params, toks)
            self.margins_of[self._rid] = self.margins[n:]
            return out

        def by_request_decode(params, caches, toks, pos, act):
            rows = np.asarray(act).nonzero()[0].tolist()
            n = len(self.margins)
            out = decode(params, caches, toks, pos, act)
            rid_of = {slot: rid for rid, slot in self.slot_of.items()}
            for slot, m in zip(rows, self.margins[n:]):
                self.margins_of[rid_of[slot]].append(m)
            return out

        self._prefill, self._decode = by_request_prefill, by_request_decode

    def submit(self, req):
        self._rid = req.rid
        return super().submit(req)


def test_train_lm_fast_learns_and_resumes(examples, tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    first = examples.train.main(["--fast", "--device", "cpu", "--steps",
                                 "50", "--ckpt-dir", ckpt])
    assert first.resumed_from == 0 and len(first.losses) == 50
    assert first.losses[-1] < first.losses[0]
    assert (tmp_path / "run.jsonl").exists()
    second = examples.train.main(["--fast", "--device", "cpu", "--steps",
                                  "100", "--ckpt-dir", ckpt])
    assert second.resumed_from == 50 and len(second.losses) == 50
    assert second.losses[-1] < first.losses[0]
    out = capsys.readouterr().out
    assert "arch=granite-3-2b-smoke steps=50 resumed_from=0" in out
    assert "arch=granite-3-2b-smoke steps=50 resumed_from=50" in out
    # --fresh starts over
    third = examples.train.main(["--fast", "--device", "cpu", "--ckpt-dir",
                                 ckpt, "--fresh"])
    assert third.resumed_from == 0 and len(third.losses) == 30


def test_lm_examples_raise_without_a_card_by_default(examples, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (examples.serve.main, examples.train.main):
        with pytest.raises(RuntimeError, match="CUDA device"):
            run([])
