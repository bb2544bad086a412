"""The port's slot decode ``Engine`` and its launcher against the
reference's on the CPU, with the same weights.

The engine cases are the reference suite's termination and admission cases
(budget, unadmitted, eos, capacity, slot reuse, FIFO) on granite-3-2b's
smoke config (the moe, ssm and hybrid families are driven in
``test_torch_lm_engine_families.py``): token streams and finish reasons
must be equal. Greedy tokens
are compared for equality, so each case also asserts that the reference's
top-2 logit margin exceeds ``lm_parity.MARGIN`` (10 x the 1e-4 logit
tolerance) at every pick, prefill and decode, so that a near-tie would
show as such and not as a flip. The launcher (``--smoke --device cpu``)
must print the reference's JSON keys with equal ``tokens``,
``decode_steps`` and active-width histogram.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

import lm_parity as P
from lm_parity import engines, run, submit
from lm_parity import prompt as _prompt
from repro.launch import serve as ref_launch
from repro_torch.launch import serve as port_launch
from repro_torch.serve import Engine, Request


@pytest.fixture(scope="module")
def granite():
    return P.models("granite-3-2b")[0]


def test_budget_counts_all_emitted_tokens(granite):
    engs = engines("granite-3-2b", max_slots=2, capacity=64)
    rng = np.random.default_rng(0)
    for rid, budget in enumerate((3, 1, 0)):
        submit(engs, rid, _prompt(granite, rng, 4 + rid),
               max_new_tokens=budget)
    outs = run(engs)
    assert [len(outs[i]) for i in range(3)] == [3, 1, 0]
    assert set(engs[1].finish_reasons().values()) == {"budget"}


def test_unadmitted_requests_are_reported(granite):
    engs = engines("granite-3-2b", max_slots=1, capacity=64)
    rng = np.random.default_rng(1)
    assert submit(engs, 0, _prompt(granite, rng, 4), max_new_tokens=50)
    assert not submit(engs, 1, _prompt(granite, rng, 5), max_new_tokens=2)
    outs = run(engs, max_steps=3)
    assert sorted(outs) == [0, 1]
    assert not engs[1].requests[0].done
    assert engs[1].requests[1].finish_reason == "unadmitted"
    assert outs[1] == []


def test_eos_termination(granite):
    rng = np.random.default_rng(2)
    prompt = _prompt(granite, rng, 6)
    engs = engines("granite-3-2b", max_slots=1, capacity=64)
    submit(engs, 0, prompt, max_new_tokens=6)
    toks = run(engs)[0]
    assert len(toks) == 6
    eos = toks[1]
    engs = engines("granite-3-2b", max_slots=1, capacity=64)
    submit(engs, 0, prompt, max_new_tokens=6, eos_id=eos)
    out = run(engs)[0]
    assert engs[1].requests[0].finish_reason == "eos"
    assert out == toks[:toks.index(eos) + 1]


def test_capacity_termination(granite):
    engs = engines("granite-3-2b", max_slots=1, capacity=16)
    rng = np.random.default_rng(3)
    submit(engs, 0, _prompt(granite, rng, 8), max_new_tokens=50)
    out = run(engs)[0]
    assert engs[1].requests[0].finish_reason == "capacity"
    # prefill token + decode up to position capacity-1: 8 tokens, not 50
    assert len(out) == 8


def test_slot_reuse_after_completion(granite):
    engs = engines("granite-3-2b", max_slots=2, capacity=64)
    # the reference suite's seed (4) gives one pick at a top-2 margin of
    # 8.7e-4, under MARGIN (the two engines still agree there)
    rng = np.random.default_rng(40)
    for rid in range(5):
        submit(engs, rid, _prompt(granite, rng, 3 + rid), max_new_tokens=3)
    outs = run(engs)
    assert sorted(outs) == list(range(5))
    assert all(len(v) == 3 for v in outs.values())
    port = engs[1]
    assert max(port.active_history) <= 2
    assert not port.active.any() and not port.slot_of and not port.pending


def test_queued_admission_is_fifo(granite):
    engs = engines("granite-3-2b", max_slots=1, capacity=64)
    rng = np.random.default_rng(5)
    for rid in range(3):
        submit(engs, rid, _prompt(granite, rng, 4), max_new_tokens=3)
    orders = []
    for eng in engs:
        order = [next(iter(eng.slot_of))]
        for _ in range(20):
            if not eng.active.any() and not eng.pending:
                break
            eng.step()
            order += [rid for rid in eng.slot_of if rid != order[-1]]
        orders.append(order)
    assert orders[0] == orders[1] == [0, 1, 2]
    assert [r.out for r in engs[1].requests.values()] == \
        [r.out for r in engs[0].requests.values()]
    assert all(r.done for r in engs[1].requests.values())


def test_engine_splices_a_prefill_into_its_slot_row():
    cfg, _, _, port = P.models("deepseek-moe-16b")
    eng = Engine(port, max_slots=3, capacity=32)
    prompt = np.arange(5) + 11
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    eng.submit(Request(rid=1, prompt=prompt[:3], max_new_tokens=2))
    with torch.inference_mode():
        _, pf = port.prefill({"tokens": torch.from_numpy(prompt[None])})
    kv, kv0 = eng.caches["kv"], eng.caches["kv0"]
    assert torch.equal(kv.k[:, 0, :5], pf["kv"].k[:, 0])     # stacked: axis 1
    assert torch.equal(kv0.k[0, :5], pf["kv0"].k[0])         # unstacked: axis 0
    assert not kv.k[:, 0, 5:].any() and not kv.k[:, 2].any()
    assert kv.k[:, 1, :3].any() and not kv.k[:, 1, 3:].any()


def test_launcher_prints_the_references_line(capsys, monkeypatch):
    port_launch.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "granite-3-2b",
                                      "--smoke"])
    ref_launch.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    for key in ("arch", "requests", "tokens", "decode_steps",
                "active_width_histogram"):
        assert got[key] == want[key], key
    assert want["decode_steps"] > 0 and sum(
        want["active_width_histogram"].values()) == want["decode_steps"]
