"""The port's slot decode ``Engine`` against the reference's on the CPU
through the moe, ssm and hybrid families, with the same weights: a
staggered trace of more requests than slots (the launcher's pattern), and
the hybrid's prompt longer than its attention window. Token streams,
finish reasons, steps and active widths must be equal, with the
reference's top-2 logit margin above ``lm_parity.MARGIN`` at every pick
(``test_torch_lm_serve.py`` holds the dense family and the launcher).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import lm_parity as P
from repro_torch.serve import FINISH_REASONS
from lm_parity import both, engines, run, submit
from lm_parity import prompt as _prompt


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_staggered_trace_through_each_family(name):
    # the launcher's pattern: a submission, then a step, with prompts of
    # 4-16 tokens; more requests than slots
    cfg = P.models(name)[0]
    engs = engines(name, max_slots=2, capacity=64)
    rng = np.random.default_rng(6)
    for rid in range(5):
        submit(engs, rid, _prompt(cfg, rng, int(rng.integers(4, 17))),
               max_new_tokens=int(rng.integers(2, 7)))
        assert both(engs, "step")[0] == engs[1].active.sum()
    run(engs)
    assert set(engs[1].finish_reasons().values()) <= set(FINISH_REASONS)


def _decode_after_prefill_error(port, seq):
    """Largest difference between the model's full forward at the last
    token of ``seq`` and a decode step after a prefill of the rest, the
    prefill's ring caches padded to the window as the engine splices
    them."""
    cfg = port.cfg
    with torch.inference_mode():
        full = port.forward({"tokens": seq})[0, -1]
        _, caches = port.prefill({"tokens": seq[:, :-1]})
        kv = caches["groups"]["2_attn"]
        pad = (0, 0, 0, 0, 0, cfg.window - kv.k.shape[2])
        caches["groups"]["2_attn"] = type(kv)(
            *(torch.nn.functional.pad(x, pad) for x in kv))
        step, _ = port.decode_step(caches, seq[:, -1:])
    return np.abs(step[0, 0].numpy() - full.numpy()).max()


def test_hybrid_prompt_longer_than_the_window():
    # the reference keeps the last `window` keys of a long prompt in rows
    # 0..window-1, not at pos % window where decode then writes: the port
    # does the same, so the two engines' streams agree, and both depart
    # from the model's own full forward after such a prompt (and only
    # after such a prompt)
    cfg, _, _, port = P.models("recurrentgemma-2b")
    rng = np.random.default_rng(7)
    prompt = _prompt(cfg, rng, cfg.window + 6)
    engs = engines("recurrentgemma-2b", max_slots=1, capacity=128)
    submit(engs, 0, prompt, max_new_tokens=4)
    out = run(engs)[0]
    seq = torch.from_numpy(np.concatenate([prompt, out[:1]])[None])
    assert _decode_after_prefill_error(port, seq) > P.LOGIT_ATOL
    assert _decode_after_prefill_error(port, seq[:, -cfg.window:]) < 5e-5
