"""The port's training substrate (``repro_torch.optim``, ``data``,
``checkpoint``, ``train.loop``, ``launch.train``) on the CPU: the
reference's substrate tests (``tests/test_substrates.py``) run against
the port, and each piece held against the reference on the same numpy
inputs: the schedule, AdamW, clipping and the int8 transform ``==``
where the arithmetic is the same (the norm's sum within float32), the
pipeline's tokens ``==``, checkpoints crossing between the packages both
ways with leaves ``==`` and dtypes kept."""
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import RunConfig as RefRunConfig
from repro.data import PipelineSpec as RefPipelineSpec
from repro.data import spec_for as ref_spec_for
from repro.optim import adamw as ref_adamw
from repro.optim import clip as ref_clip
from repro.optim import compression as ref_compression
from repro_torch.checkpoint import ckpt
from repro_torch.configs import SHAPES, RunConfig, get_arch
from repro_torch.data import PipelineSpec, make_batch, spec_for
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim import adamw, clip, compression
from repro_torch.train import Watchdog, train_loop

ROOT = Path(__file__).resolve().parents[1]


def t(a):
    return torch.from_numpy(np.array(a))


def np_of(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# ---------------------------------------------------------------------------
# optimizer: the reference's tests against the port
# ---------------------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    rc = RunConfig(learning_rate=0.1, warmup_steps=0, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = adamw.apply(rc, params, grads, state, 1000)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_weight_decay_only_on_matrices():
    rc = RunConfig(learning_rate=0.01, warmup_steps=0, weight_decay=0.5)
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    state = adamw.init(params)
    zero = {"w": torch.zeros((4, 4)), "b": torch.zeros((4,))}
    p2, _ = adamw.apply(rc, params, zero, state, 1000)
    assert float(p2["w"].max()) < 1.0         # decayed
    assert float(p2["b"].min()) == 1.0        # bias untouched


def test_adamw_decay_set_overrides_the_rank_rule():
    rc = RunConfig(learning_rate=0.01, warmup_steps=0, weight_decay=0.5)
    params = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    zero = {k: torch.zeros_like(p) for k, p in params.items()}
    p2, _ = adamw.apply(rc, params, zero, adamw.init(params), 1000,
                        decay={"w": False, "b": True})
    assert float(p2["w"].min()) == 1.0
    assert float(p2["b"].max()) < 1.0


def test_warmup_cosine_schedule():
    rc = RunConfig(learning_rate=1e-3, warmup_steps=10)
    lrs = [float(adamw.schedule(rc, s, 100)) for s in range(101)]
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[100] < lrs[10]


@pytest.mark.parametrize("lr,warmup,total", [
    (1e-3, 10, 100), (3e-4, 100, 10_000), (5e-3, 0, 37), (3e-3, 2, 30)])
def test_schedule_equals_the_reference_in_float32(lr, warmup, total):
    rc, ref_rc = (RunConfig(learning_rate=lr, warmup_steps=warmup),
                  RefRunConfig(learning_rate=lr, warmup_steps=warmup))
    got = np.array([adamw.schedule(rc, s, total) for s in range(101)])
    want = np.array([np.float32(ref_adamw.schedule(ref_rc, s, total))
                     for s in range(101)])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _plain_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "e": rng.standard_normal((2, 3, 4)).astype(np.float32)}


def test_adamw_equals_the_reference_step_by_step():
    # the same elementwise operations in the same order: `==` over 5 steps
    rc = RunConfig(learning_rate=1e-2, warmup_steps=2, weight_decay=0.1)
    ref_rc = RefRunConfig(learning_rate=1e-2, warmup_steps=2,
                          weight_decay=0.1)
    p0 = _plain_tree(0)
    params = {k: t(v) for k, v in p0.items()}
    state = adamw.init(params)
    ref_params = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_state = ref_adamw.init(ref_params)
    for s in range(5):
        g = _plain_tree(100 + s)
        params, state = adamw.apply(rc, params, {k: t(v) for k, v in
                                                 g.items()}, state, 50)
        ref_params, ref_state = ref_adamw.apply(
            ref_rc, ref_params, {k: jnp.asarray(v) for k, v in g.items()},
            ref_state, 50)
        assert int(state.step) == int(ref_state.step) == s + 1
        for k in p0:
            np.testing.assert_array_equal(np_of(params[k]),
                                          np.asarray(ref_params[k]))
            np.testing.assert_array_equal(np_of(state.mu[k]),
                                          np.asarray(ref_state.mu[k]))
            np.testing.assert_array_equal(np_of(state.nu[k]),
                                          np.asarray(ref_state.nu[k]))


def test_adamw_keeps_bfloat16_params_with_float32_moments():
    rc = RunConfig(learning_rate=1e-2, warmup_steps=0)
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = adamw.init(params)
    p2, s2 = adamw.apply(rc, params, {"w": torch.full((4, 4), 0.5,
                                                      dtype=torch.bfloat16)},
                         state, 100)
    assert p2["w"].dtype == torch.bfloat16
    assert s2.mu["w"].dtype == s2.nu["w"].dtype == torch.float32
    assert float(p2["w"].max()) < 1.0


def test_global_norm_clip():
    g = {"a": torch.full((10,), 3.0)}
    clipped, norm = clip.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 3.0 * np.sqrt(10)) < 1e-4
    assert abs(float(clip.global_norm(clipped)) - 1.0) < 1e-4
    g2, _ = clip.clip_by_global_norm({"a": torch.ones((2,)) * 0.1}, 1.0)
    np.testing.assert_allclose(np_of(g2["a"]), 0.1)  # below: untouched


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_equals_the_reference(max_norm):
    g = _plain_tree(7)
    got, norm = clip.clip_by_global_norm({k: t(v) for k, v in g.items()},
                                         max_norm)
    want, ref_norm = ref_clip.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    # the leaves' sums of squares are added in another order
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(np_of(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_int8_ef_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    g = {"w": t(rng.standard_normal((64, 64)).astype(np.float32))}
    ef = compression.init_ef(g)
    q, s, ef2 = compression.compress(g, ef)
    deq = compression.decompress(q, s)
    err = float((deq["w"] - g["w"]).abs().max())
    assert err <= float(s["w"]) * 0.5 + 1e-6   # half-ulp of int8 grid
    assert q["w"].dtype == torch.int8


def test_error_feedback_accumulates_truncation():
    g = {"w": torch.tensor([1.0] + [0.004] * 7)}
    ef = compression.init_ef(g)
    total = np.zeros(8)
    for _ in range(64):
        q, s, ef = compression.compress(g, ef)
        total += np_of(compression.decompress(q, s)["w"])
    np.testing.assert_allclose(total / 64, np_of(g["w"]), rtol=0.05)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_compression_property_bounded_error(seed):
    rng = np.random.default_rng(seed)
    x = t((rng.standard_normal(128) * rng.uniform(0.1, 100))
          .astype(np.float32))
    ef = compression.init_ef({"x": x})
    q, s, ef2 = compression.compress({"x": x}, ef)
    deq = compression.decompress(q, s)["x"]
    assert float((deq + ef2.error["x"] - x).abs().max()) < 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compression_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    g = {"w": (rng.standard_normal((32, 16)) * 10 ** rng.uniform(-3, 3))
         .astype(np.float32),
         # ties at half a quantum round to even in both
         "h": (np.arange(-8, 9) * 0.5 * 3 / 127).astype(np.float32),
         "z": np.zeros(4, np.float32)}
    e = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in g.items()}
    q, s, ef = compression.compress({k: t(v) for k, v in g.items()},
                                    compression.EFState(
                                        {k: t(v) for k, v in e.items()}))
    rq, rs, ref_ef = ref_compression.compress(
        {k: jnp.asarray(v) for k, v in g.items()},
        ref_compression.EFState({k: jnp.asarray(v) for k, v in e.items()}))
    for k in g:
        assert q[k].dtype == torch.int8
        np.testing.assert_array_equal(np_of(q[k]), np.asarray(rq[k]))
        np.testing.assert_array_equal(np_of(s[k]), np.asarray(rs[k]))
        np.testing.assert_array_equal(np_of(ef.error[k]),
                                      np.asarray(ref_ef.error[k]))
    deq = compression.decompress(q, s)
    ref_deq = ref_compression.decompress(rq, rs)
    for k in g:
        np.testing.assert_array_equal(np_of(deq[k]), np.asarray(ref_deq[k]))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_pipeline_deterministic_and_sharded():
    spec = PipelineSpec(vocab=100, seq_len=32, global_batch=8, seed=3)
    b1 = spec.batch_at(5)
    np.testing.assert_array_equal(b1, spec.batch_at(5))
    assert not np.array_equal(b1, spec.batch_at(6))
    slices = [spec.host_slice(5, h, 4) for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(slices), b1)
    assert b1.min() >= 0 and b1.max() < 100


def test_pipeline_has_learnable_structure():
    spec = PipelineSpec(vocab=97, seq_len=128, global_batch=4, seed=0)
    row = spec.batch_at(0)[0].astype(np.int64)
    a_pool, b_pool = spec._rules()
    best = max(sum(1 for i in range(1, 128)
                   if row[i] == (a * row[i - 1] + c) % 97)
               for a, c in zip(a_pool, b_pool))
    assert best >= 0.8 * 127, best


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (100, 32, 8, 3, 5), (512, 16, 4, 1, 0), (49155, 128, 2, 0, 7)])
def test_batch_at_equals_the_reference(vocab, seq, batch, seed, step):
    got = PipelineSpec(vocab, seq, batch, seed).batch_at(step)
    want = RefPipelineSpec(vocab, seq, batch, seed).batch_at(step)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        PipelineSpec(vocab, seq, batch, seed).host_slice(step, 1, 2),
        RefPipelineSpec(vocab, seq, batch, seed).host_slice(step, 1, 2))


@pytest.mark.parametrize("name", ["granite-3-2b", "internvl2-76b",
                                  "whisper-tiny"])
def test_make_batch_on_the_host(name):
    cfg = get_arch(name, smoke=True)
    spec = PipelineSpec(cfg.vocab_size, 16, 4, seed=2)
    b = make_batch(cfg, spec, 3, device="cpu")
    assert b["tokens"] is b["labels"]
    assert b["tokens"].dtype == torch.int32 and b["tokens"].device.type \
        == "cpu"
    np.testing.assert_array_equal(b["tokens"].numpy(), spec.batch_at(3))
    stub = {"audio": ("frames", cfg.encoder_seq),
            "vlm": ("image_embeds", cfg.num_image_tokens)}.get(cfg.family)
    assert set(b) == {"tokens", "labels"} | ({stub[0]} if stub else set())
    if stub:
        # the reference's shape, dtype and scale; the same values for the
        # same (seed, step), others for another step
        x = b[stub[0]]
        assert x.shape == (4, stub[1], cfg.d_model)
        assert x.dtype == torch.float32
        assert 0.08 < float(x.std()) < 0.12
        assert torch.equal(x, make_batch(cfg, spec, 3, device="cpu")[stub[0]])
        assert not torch.equal(x, make_batch(cfg, spec, 4,
                                             device="cpu")[stub[0]])


def test_spec_for_equals_the_reference():
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_arch as ref_get_arch

    for name in ("granite-3-2b", "internvl2-76b"):
        got = spec_for(get_arch(name), SHAPES["train_4k"], seed=4, batch=2)
        want = ref_spec_for(ref_get_arch(name), REF_SHAPES["train_4k"],
                            seed=4, batch=2)
        assert (got.vocab, got.seq_len, got.global_batch, got.seed) == \
            (want.vocab, want.seq_len, want.global_batch, want.seed)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

class Moments(NamedTuple):
    mu: Any
    nu: Any


def _mixed_tree_np():
    rng = np.random.default_rng(5)
    return {"a": np.arange(10, dtype=np.float32),
            "nested": {"b": rng.standard_normal((3, 4)).astype(np.float32),
                       "i": np.arange(6, dtype=np.int32).reshape(2, 3)},
            "list": [np.zeros(2, np.float32), np.ones(3, np.float32)],
            "opt": Moments(mu={"w": np.full((2, 2), 0.5, np.float32)},
                           nu={"w": np.full((2, 2), 0.25, np.float32)}),
            "step": np.asarray(7, np.int32)}


def _to_port(tree):
    out = jax.tree_util.tree_map(t, tree)
    out["nested"]["b"] = out["nested"]["b"].to(torch.bfloat16)
    return out


def _to_ref(tree):
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["nested"]["b"] = out["nested"]["b"].astype(jnp.bfloat16)
    return out


def _bits(x):
    """A leaf's bits and dtype name, from either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    a = np.asarray(x)
    name = str(a.dtype)
    return (a.view(np.uint16) if name == "bfloat16" else a), name


def _same_leaves(port_tree, ref_tree):
    got = ckpt._leaves(port_tree)
    want = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = list(got)
    assert [k for k, _ in got] == ["/".join(ref_ckpt._path_str(p) for p in
                                            path) for path, _ in want]
    for (key, a), (_, b) in zip(got, want):
        (ga, gn), (wa, wn) = _bits(a), _bits(b)
        assert gn == wn, (key, gn, wn)
        np.testing.assert_array_equal(ga, wa, err_msg=key)


def test_ckpt_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "nested": {"b": torch.ones((3, 4), dtype=torch.bfloat16)},
            "list": [torch.zeros(2), torch.ones(3)]}
    ckpt.save(str(tmp_path), 7, tree, {"step": 7})
    like = {"a": torch.zeros(10), "nested": {"b": torch.zeros(3, 4)},
            "list": [torch.zeros(2), torch.zeros(3)]}
    got, extra = ckpt.restore(str(tmp_path), like)
    assert extra["step"] == 7
    for (_, a), (_, b) in zip(ckpt._leaves(tree), ckpt._leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_ckpt_latest_pointer_atomic(tmp_path):
    tree = {"x": torch.ones(4)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, tree)
    assert ckpt.latest_step(str(tmp_path)) == 2
    os.makedirs(tmp_path / "step_00000003")
    with open(tmp_path / "LATEST", "w") as f:
        f.write("step_00000003")
    assert ckpt.latest_step(str(tmp_path)) is None


def test_ckpt_async_saver_snapshots_on_the_callers_thread(tmp_path):
    tree = {"x": torch.arange(1000, dtype=torch.float32)}
    s = ckpt.AsyncSaver()
    s.save(str(tmp_path), 5, tree)
    tree["x"].add_(1.0)        # an in-place update after save() returns
    s.wait()
    got, _ = ckpt.restore(str(tmp_path), tree)
    np.testing.assert_array_equal(got["x"].numpy(), np.arange(1000))


def test_ckpt_rejects_shape_mismatch_missing_leaf_and_shardings(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.ones(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"x": torch.ones(5)})
    with pytest.raises(KeyError, match="missing leaf y"):
        ckpt.restore(str(tmp_path), {"y": torch.ones(4)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"x": torch.ones(4)})
    # shardings= places the leaves it gives a NamedSharding (held on gloo
    # ranks: test_torch_mesh_ranks.py, the elastic case, onto (4, 1) and
    # (1, 4)); a leaf it gives None restores as without it
    got, _ = ckpt.restore(str(tmp_path), {"x": torch.ones(4)},
                          shardings={"x": None})
    assert torch.equal(got["x"], torch.ones(4))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _mixed_tree_np()
    ref_ckpt.save(str(tmp_path), 3, _to_ref(tree), {"step": 3},
                  shard_mb=0)   # a shard per leaf
    like = jax.tree_util.tree_map(lambda a: torch.zeros(a.shape), tree)
    got, extra = ckpt.restore(str(tmp_path), like)
    assert extra == {"step": 3}
    _same_leaves(got, _to_ref(tree))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _mixed_tree_np()
    ckpt.save(str(tmp_path), 4, _to_port(tree), {"step": 4}, shard_mb=0)
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["leaves"]["nested/b"]["dtype"] == "bfloat16"
    assert manifest["n_shards"] == len(manifest["leaves"])
    like = jax.tree_util.tree_map(jnp.zeros_like, _to_ref(tree))
    got, extra = ref_ckpt.restore(str(tmp_path), like)
    assert extra == {"step": 4}
    _same_leaves(_to_port(tree), got)


def test_checkpoint_files_are_the_references(tmp_path):
    tree = _mixed_tree_np()
    ckpt.save(str(tmp_path / "port"), 2, _to_port(tree))
    ref_ckpt.save(str(tmp_path / "ref"), 2, _to_ref(tree))
    files = lambda d: sorted(os.listdir(d / "step_00000002"))  # noqa: E731
    assert files(tmp_path / "port") == files(tmp_path / "ref")
    manifests = [json.load(open(d / "step_00000002" / "manifest.json"))
                 for d in (tmp_path / "port", tmp_path / "ref")]
    assert manifests[0] == manifests[1]
    assert [open(d / "LATEST").read() for d in
            (tmp_path / "port", tmp_path / "ref")] == ["step_00000002"] * 2


# ---------------------------------------------------------------------------
# training loop: loss goes down; crash + restart is bit-identical
# ---------------------------------------------------------------------------

def _tiny_setup(tmp_path, ckpt_every=4, async_ckpt=False):
    cfg = get_arch("granite-3-2b", smoke=True)
    model = build_model(cfg, device="cpu", seed=1)
    rc = RunConfig(learning_rate=3e-3, warmup_steps=2, ckpt_dir=str(tmp_path),
                   ckpt_every=ckpt_every, async_ckpt=async_ckpt, seed=1)
    spec = PipelineSpec(vocab=cfg.vocab_size, seq_len=32, global_batch=4,
                        seed=1)
    return cfg, model, rc, spec


def test_train_loss_decreases(tmp_path):
    cfg, model, rc, spec = _tiny_setup(tmp_path, ckpt_every=0)
    rc = RunConfig(learning_rate=5e-3, warmup_steps=5,
                   ckpt_dir=rc.ckpt_dir, ckpt_every=0, async_ckpt=False,
                   seed=1, weight_decay=0.0)
    res = train_loop(model, cfg, rc, spec, n_steps=30)
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5]) - 0.05


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_crash_restart_bit_identical(tmp_path, async_ckpt):
    cfg, model, rc, spec = _tiny_setup(tmp_path / "a", async_ckpt=async_ckpt)
    ref = train_loop(model, cfg, rc, spec, n_steps=10)
    # crashed run: dies at step 7, restarts from the step-4 checkpoint with
    # the model it crashed with (weights updated through step 6)
    cfg2, model2, rc2, spec2 = _tiny_setup(tmp_path / "b",
                                           async_ckpt=async_ckpt)
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        train_loop(model2, cfg2, rc2, spec2, n_steps=10, fail_at_step=7)
    res = train_loop(model2, cfg2, rc2, spec2, n_steps=10)
    assert res.resumed_from == 4
    assert int(res.state.step) == 10
    np.testing.assert_array_equal(np.asarray(ref.losses[4:]),
                                  np.asarray(res.losses))
    for k, p in ref.state.params.items():
        assert torch.equal(p, res.state.params[k]), k
        assert torch.equal(ref.state.opt.mu[k], res.state.opt.mu[k]), k
        assert torch.equal(ref.state.opt.nu[k], res.state.opt.nu[k]), k
    # the state's parameters are the model's own
    assert all(p is res.state.params[k]
               for k, p in model2.named_parameters())


def test_train_loop_logs_the_references_lines(tmp_path):
    cfg, model, rc, spec = _tiny_setup(tmp_path / "c", ckpt_every=0)
    log = tmp_path / "log.jsonl"
    res = train_loop(model, cfg, rc, spec, n_steps=3, log_path=str(log))
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1, 2]
    assert [x["loss"] for x in lines] == res.losses
    assert all(set(x) == {"step", "loss", "dt", "straggler"} and x["dt"] > 0
               for x in lines)


def test_watchdog_flags_stragglers():
    wd = Watchdog(window=20, k=3.0)
    for i in range(20):
        wd.record(i, 0.10 + 0.001 * (i % 3))
    assert wd.record(20, 0.5)       # 5x median: straggler
    assert not wd.record(21, 0.101)
    assert wd.flagged == [20]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(*args, tmp_path):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_launch_train_smoke_on_the_host_prints_the_references_line(tmp_path):
    out = _launch("--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                  "--steps", "6", "--batch", "4", "--seq", "32",
                  "--ckpt-every", "3", "--ckpt-dir", "ck", tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["arch", "steps", "resumed_from", "first_loss",
                          "last_loss", "stragglers"]
    assert line["arch"] == "granite-3-2b-smoke" and line["steps"] == 6
    assert line["resumed_from"] == 0
    assert np.isfinite([line["first_loss"], line["last_loss"]]).all()
    assert ckpt.latest_step(str(tmp_path / "ck")) == 6


def test_launch_train_refuses_a_mesh(tmp_path):
    # --mesh 2x1 on the host trains on two gloo ranks the launcher starts;
    # its losses agree with --mesh 1x1's (the launcher's run, in this
    # process) within the sharded step's bars. On the card it needs one
    # card a rank: with fewer it raises.
    common = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
              "--steps", "4", "--batch", "4", "--seq", "32",
              "--ckpt-every", "2"]
    _, _, _, _, res = launch_train.run(launch_train.parser().parse_args(
        common + ["--mesh", "1x1", "--ckpt-dir", str(tmp_path / "ck1x1")]))
    out = _launch(*common, "--mesh", "2x1", "--ckpt-dir", "ck2x1", "--log",
                  "log2x1.jsonl", tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["steps"] == 4 and line["resumed_from"] == 0
    losses = [json.loads(x)["loss"] for x in
              (tmp_path / "log2x1.jsonl").read_text().splitlines()]
    assert len(losses) == 4
    np.testing.assert_allclose(losses, res.losses, rtol=0, atol=1e-5)
    assert ckpt.latest_step(str(tmp_path / "ck2x1")) == 4
    out = _launch("--arch", "granite-3-2b", "--smoke", "--device", "cuda",
                  "--mesh", "2x1", tmp_path=tmp_path)
    if torch.cuda.device_count() < 2:
        assert out.returncode != 0
        assert "needs 2 CUDA devices" in out.stderr


def test_launch_train_under_torchrun_checks_its_world_not_the_nodes_cards(
        monkeypatch):
    # torchrun's world may span nodes: the launcher holds WORLD_SIZE to
    # D*M and needs this rank's own card on its node, never D*M cards on
    # one node. Each refusal comes before the world is joined; a run that
    # passes the checks goes on to join it (stubbed here: a pytest worker
    # never joins a process group).
    def join(*args, **kwargs):
        raise RuntimeError("joins the world")

    monkeypatch.setattr(launch_train.dist, "init_process_group", join)
    common = ["--arch", "granite-3-2b", "--smoke"]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(SystemExit, match="needs a world of 2 ranks"):
        launch_train.main(common + ["--device", "cpu", "--mesh", "2x1"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="joins the world"):
        launch_train.main(common + ["--device", "cpu", "--mesh", "2x1"])
    n = torch.cuda.device_count()
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_RANK", str(n))
    with pytest.raises(SystemExit, match=f"local rank {n} with --device "
                                         f"cuda needs card {n}"):
        launch_train.main(common + ["--device", "cuda", "--mesh", "16x1"])
