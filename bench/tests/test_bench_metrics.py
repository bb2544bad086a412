"""The yardstick's arithmetic on the CPU: a rate is a total over a total,
the frozen FLOP count equals the program's, and the traffic and the
weights are the same for the same seed."""
from __future__ import annotations

import importlib.util
import json

import pytest
import torch
from bench_smoke import BENCH, ROOT

from harness import cells, flops, traffic, weights
from harness.record import Run

CONFIG = json.loads((BENCH / "configs" / "granite-3-2b.json").read_text())


def _metric(name):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_rates_are_totals_over_totals():
    run = Run(cell=None, seed=0, seconds=2, trace=False, device="cpu")
    run.t_start, run.t_end = 10.0, 12.5
    # three steps of unequal length: the rate is every token over the
    # whole window, not a mean of the steps' rates
    run.steps = [(10.0, 10.5), (10.5, 11.0), (11.0, 12.5)]
    run.tokens = 3 * 2048
    assert _metric("train_tokens_per_s")(run) == pytest.approx(6144 / 2.5)
    run.cell = type("C", (), {"model": CONFIG["model"]})()
    assert _metric("mfu.train")(run) == pytest.approx(
        100 * 6 * flops.param_count(CONFIG["model"])[1] * 6144
        / (2.5 * 67e12))
    run.tokens = 0
    assert _metric("train_tokens_per_s")(run) is None


def test_frozen_counts_equal_the_programs():
    from repro_torch.configs.base import ModelConfig, ShapeConfig
    from repro_torch.roofline import analysis

    m = CONFIG["model"]
    cfg = ModelConfig(**m)
    assert flops.param_count(m) == analysis.param_count(cfg)
    # the program's count leaves the norms' weights out
    norms = (2 * m["n_layers"] + 1) * m["d_model"]
    assert flops.param_count(m)[0] == weights.n_params(m) - norms
    shape = ShapeConfig("t", 512, 4, "train")
    assert flops.train_flops(m, 2048) == analysis.model_flops(cfg, shape)


def test_traffic_is_the_same_for_the_same_seed():
    feed = json.loads((BENCH / "traffic" / "train.json").read_text())
    f1, f2 = (traffic.TrainFeed(feed, CONFIG["model"], 4462821338, "cpu")
              for _ in range(2))
    assert torch.equal(f1.batch(3)["tokens"], f2.batch(3)["tokens"])
    assert not torch.equal(f1.batch(3)["tokens"], f1.batch(4)["tokens"])
    other = traffic.TrainFeed(feed, CONFIG["model"], 7, "cpu")
    assert not torch.equal(f1.batch(3)["tokens"], other.batch(3)["tokens"])
    toks = f1.batch(0)["tokens"]
    assert toks.shape == (4, 512)
    assert 0 <= int(toks.min()) and int(toks.max()) < 49155


def test_weights_are_the_same_for_the_same_seed():
    m = dict(CONFIG["model"], n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=2, head_dim=16, d_ff=16, vocab_size=100,
             vocab_pad=64)
    a, b = weights.make_all(m, 3, "cpu"), weights.make_all(m, 3, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.embedding"],
                           weights.make_all(m, 4, "cpu")["embed.embedding"])


def test_benchmark_file_names_a_reader_for_every_metric():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for w in spec["workloads"]:
        cell = cells.load(ROOT, w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
        assert set(cell.limits)
