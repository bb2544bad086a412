"""The port's train step against the reference's on the CPU, per family,
at smoke size: the same weights (``convert.lm_params_from_numpy``) and
the same numpy batch through ``make_train_step`` and through the
reference's ``jax.value_and_grad`` + ``clip`` + ``adamw.apply`` with
weight decay 0.1; the decay set against the reference's rank rule leaf
for leaf, at every arch's smoke and published layout; the converter's
inverse; microbatching against the full batch.

Bars. The loss, the model's metrics and the gradient norm within 1e-5
(relative for the norm, which is of order 1-10); every gradient within
1e-5 (measured ~1e-6). After one AdamW step a weight moves by
``lr * (g / (|g| + 1e-8) + wd * w)``: at step 1 the first term is the
sign of ``g``, so where the reference's clipped gradient is below
``G_SIGN`` in size the two packages' float32 noise may pick opposite
signs and the weights may differ by up to ``2 * lr``; everywhere else
they differ by float32 rounding (``P_ATOL``), and a wrong decay set or
a wrong step size shows there."""
import jax
import numpy as np
import pytest
import torch

from lm_parity import batch, models, np_tree, to_jax, to_torch
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import RunConfig as RefRunConfig
from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.optim import clip as ref_clip
from repro_torch import convert
from repro_torch.configs import RunConfig, get_arch
from repro_torch.data import PipelineSpec, make_batch
from repro_torch.models import LM, EncDec, build_model
from repro_torch.train import init_state, make_train_step

FAMILIES = ["granite-3-2b", "deepseek-moe-16b", "mamba2-780m",
            "recurrentgemma-2b", "whisper-tiny", "internvl2-76b"]
LR, WD = 1e-3, 0.1
TOTAL = 100
LOSS_ATOL = GRAD_ATOL = 1e-5
NORM_RTOL = 1e-5
G_SIGN = 1e-4
P_ATOL = 1e-6


def _port_model(name, params):
    pcfg = get_arch(name, smoke=True)
    port = build_model(pcfg, device="cpu")
    port.load_state_dict(convert.lm_params_from_numpy(pcfg, np_tree(params)))
    return pcfg, port


def _flat(tree):
    return dict(convert._leaves(tree, ""))


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_the_reference(name):
    cfg, ref, params, _ = models(name)
    pcfg, port = _port_model(name, params)
    b = batch(cfg, seed=11, B=2, S=32)
    rc = RunConfig(learning_rate=LR, warmup_steps=0, weight_decay=WD)
    ref_rc = RefRunConfig(learning_rate=LR, warmup_steps=0, weight_decay=WD)

    (ref_loss, ref_m), ref_grads = jax.jit(jax.value_and_grad(
        ref.loss, has_aux=True))(params, to_jax(b))
    clipped, ref_norm = ref_clip.clip_by_global_norm(ref_grads,
                                                     ref_rc.grad_clip)
    ref_params, _ = ref_adamw.apply(ref_rc, params, clipped,
                                    ref_adamw.init(params), TOTAL)

    # the gradients, through the port's loss
    loss, _ = port.loss(to_torch(b))
    loss.backward()
    grads = convert.lm_params_to_numpy(
        pcfg, {k: p.grad for k, p in port.named_parameters()})
    port.zero_grad(set_to_none=True)
    want_g, got_g = _flat(np_tree(ref_grads)), _flat(grads)
    assert sorted(got_g) == sorted(want_g)
    for k, w in want_g.items():
        assert np.isfinite(got_g[k]).all(), k
        np.testing.assert_allclose(got_g[k], w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=k)

    state = init_state(port, rc)
    state, m = make_train_step(port, rc, TOTAL)(state, to_torch(b))
    assert int(state.step) == int(state.opt.step) == 1
    assert m["lr"] == np.float32(ref_adamw.schedule(ref_rc, 1, TOTAL))
    for key, want in (("loss", ref_loss), ("ce", ref_m["ce"]),
                      ("aux", ref_m["aux"])):
        assert abs(float(m[key]) - float(want)) <= LOSS_ATOL, key
    assert abs(float(m["grad_norm"]) - float(ref_norm)) <= \
        NORM_RTOL * float(ref_norm)

    # the step updated the model's own parameters
    assert all(p is state.params[k] for k, p in port.named_parameters())
    got_p = _flat(convert.lm_params_to_numpy(pcfg, state.params))
    want_p, g = _flat(np_tree(ref_params)), _flat(np_tree(clipped))
    assert sorted(got_p) == sorted(want_p)
    n_sign = 0
    for k, w in want_p.items():
        diff = np.abs(got_p[k] - w)
        sign = np.abs(g[k]) < G_SIGN
        n_sign += int((sign & (diff > P_ATOL)).sum())
        assert (diff[~sign] <= P_ATOL).all(), (k, diff[~sign].max())
        assert (diff[sign] <= 2 * LR + P_ATOL).all(), k
    # a sign flip is rare: the bar is not what holds the two together
    assert n_sign <= 1e-3 * sum(a.size for a in want_p.values()), n_sign


def _ref_shapes(cfg):
    ref = ref_build_model(cfg)
    return {k: tuple(v.shape) for k, v in
            _flat(jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0))))
            .items()}


def _meta_model(pcfg):
    cls = EncDec if pcfg.family == "audio" else LM
    return cls(pcfg, device=torch.device("meta"), generator=torch.Generator())


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_decay_set_is_the_references_rank_rule(name, smoke):
    # shapes only: the reference's by eval_shape, the port's on the meta
    # device; recurrentgemma-2b published is 8 groups + a 2-layer tail
    pcfg = get_arch(name, smoke=smoke)
    want = _ref_shapes(ref_get_arch(name, smoke=smoke))
    params = dict(_meta_model(pcfg).named_parameters())
    decay = convert.lm_decay(pcfg, params)
    seen: dict[str, list] = {}
    for k, p in params.items():
        path, i = convert._reference_place(pcfg, k)
        shape = want[path]
        assert shape == ((shape[0],) if i is not None else ()) + \
            tuple(p.shape), k
        seen.setdefault(path, []).append(i)
        assert decay[k] == (len(shape) >= 2), k
    assert set(seen) == set(want)
    for path, idx in seen.items():
        assert sorted(idx, key=lambda i: -1 if i is None else i) == (
            [None] if idx == [None] else list(range(want[path][0]))), path
    if smoke:
        return
    n_1d = sum(1 for k, p in params.items() if p.ndim == 1 and not decay[k])
    assert n_1d == sum(len(s) == 1 for s in want.values())
    if name == "recurrentgemma-2b":
        assert not decay["blocks.24.ln_mix.scale"]         # the tail
        assert decay["blocks.23.ln_mix.scale"]             # a group


@pytest.mark.parametrize("name", FAMILIES)
def test_params_to_numpy_inverts_from_numpy(name):
    cfg, _, params, _ = models(name)
    pcfg = get_arch(name, smoke=True)
    tree = np_tree(params)
    back = convert.lm_params_to_numpy(
        pcfg, convert.lm_params_from_numpy(pcfg, tree))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_microbatch_grad_accum_matches_full():
    cfg = get_arch("granite-3-2b", smoke=True)
    spec = PipelineSpec(vocab=cfg.vocab_size, seq_len=16, global_batch=8)
    b = make_batch(cfg, spec, 0, device="cpu")
    out = {}
    for mb in (0, 4):
        model = build_model(cfg, device="cpu")
        rc = RunConfig(microbatch=mb, weight_decay=0.0)
        out[mb] = make_train_step(model, rc)(init_state(model, rc), b)
    (s_full, m_full), (s_micro, m_micro) = out[0], out[4]
    assert abs(float(m_full["loss"]) - float(m_micro["loss"])) < 1e-4
    assert abs(float(m_full["grad_norm"]) - float(m_micro["grad_norm"])) \
        <= NORM_RTOL * float(m_full["grad_norm"])
    for k, p in s_full.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   s_micro.params[k].detach().numpy(),
                                   atol=2e-5)


def test_microbatch_loss_is_the_mean_and_metrics_the_last():
    cfg = get_arch("granite-3-2b", smoke=True)
    spec = PipelineSpec(vocab=cfg.vocab_size, seq_len=16, global_batch=4)
    b = make_batch(cfg, spec, 1, device="cpu")
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        parts = [model.loss({k: v[i:i + 2] for k, v in b.items()})
                 for i in (0, 2)]
    rc = RunConfig(microbatch=2)
    _, m = make_train_step(model, rc)(init_state(model, rc), b)
    assert float(m["loss"]) == float((parts[0][0] + parts[1][0]) / 2)
    assert float(m["ce"]) == float(parts[1][1]["ce"])
