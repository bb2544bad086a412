"""The port's LM layers, one module at a time, against the reference's on
the CPU: configs, norms, RoPE, the three MLP activations, attention
(causal, banded, q-chunked) and its decode with per-slot positions and a
full ring, MoE routing with capacity overflow, and the parameter
converter. The recurrent layers and Whisper are held in
``test_torch_lm_recurrent.py``.

Inputs come from numpy seeds; weights are the reference's, loaded into the
port's modules. Tolerance: float32 outputs within ``ATOL`` (1e-4 for
logits, ``lm_parity.LOGIT_ATOL``; 2e-5 for a single layer's output of
order 1), integer plans equal.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import lm_parity as P
from lm_parity import ATOL, KEY, close, kw, load, normal, t
from repro import configs as ref_configs
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro_torch import configs, convert
from repro_torch.configs import egpu_paper
from repro_torch.models import attention, layers, moe
from repro_torch.models import build_model

# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_copy_the_reference_field_for_field():
    assert list(configs.ARCHS) == list(ref_configs.ARCHS)
    for name, cfg in configs.ARCHS.items():
        want = dataclasses.asdict(ref_configs.ARCHS[name])
        assert dataclasses.asdict(cfg) == want, name
        assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(
            ref_configs.ARCHS[name].smoke()), name
        assert cfg.padded_vocab == ref_configs.ARCHS[name].padded_vocab
        for shape in configs.SHAPES.values():
            assert configs.shape_applicable(cfg, shape) == \
                ref_configs.shape_applicable(ref_configs.ARCHS[name],
                                             ref_configs.SHAPES[shape.name])
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    run, ref_run = (dataclasses.asdict(c()) for c in
                    (configs.RunConfig, ref_configs.RunConfig))
    # the checkpoint directory is the one field the port sets apart: it
    # stays inside the working directory
    assert run.pop("ckpt_dir") == "checkpoints"
    ref_run.pop("ckpt_dir")
    assert run == ref_run
    with pytest.raises(KeyError):
        configs.get_arch("no-such-arch")


def test_yi_6b_keeps_its_published_dimensions():
    c = configs.get_arch("yi-6b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab_size, c.rope_theta) == (32, 4096, 32, 4, 11008, 64000,
                                            5e6)


def test_paper_machine_config_is_the_ports_sm_config():
    from repro.configs import egpu_paper as ref_paper
    from repro_torch.core.machine import SMConfig

    assert isinstance(egpu_paper.CONFIG, SMConfig)
    assert dataclasses.asdict(egpu_paper.CONFIG) == \
        dataclasses.asdict(ref_paper.CONFIG)
    assert egpu_paper.QUAD == ref_paper.QUAD


# ---------------------------------------------------------------------------
# norms, RoPE, MLPs, embeddings
# ---------------------------------------------------------------------------

def test_rmsnorm_and_layernorm_match_reference():
    rng = np.random.default_rng(1)
    x = normal(rng, 3, 5, 64, scale=3.0)
    scale, bias = normal(rng, 64, scale=0.5), normal(rng, 64, scale=0.5)
    p = layers.RMSNorm(64, dtype=torch.float32, device="cpu")
    load(p, {"scale": scale})
    close(layers.rmsnorm(p, t(x), 1e-5),
          r_layers.rmsnorm({"scale": scale}, jnp.asarray(x), 1e-5))
    q = layers.LayerNorm(64, dtype=torch.float32, device="cpu")
    load(q, {"scale": scale, "bias": bias})
    close(layers.layernorm(q, t(x)),
          r_layers.layernorm({"scale": scale, "bias": bias}, jnp.asarray(x)))


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_reference(per_row):
    rng = np.random.default_rng(2)
    x = normal(rng, 2, 7, 3, 32)
    pos = (rng.integers(0, 5000, (2, 7)) if per_row
           else np.arange(7)).astype(np.int32)
    close(layers.apply_rope(t(x), t(pos), 5e6),
          r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6),
          atol=1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(activation):
    rng = np.random.default_rng(3)
    tree = r_layers.mlp_params(KEY, 64, 96, activation, jnp.float32)
    p = load(layers.MLP(64, 96, activation, **kw()), tree)
    x = normal(rng, 2, 5, 64, scale=2.0)
    close(layers.mlp(p, t(x), activation),
          r_layers.mlp(tree, jnp.asarray(x), activation))


def test_gelu_is_the_tanh_form(monkeypatch):
    # the reference's GELU is the tanh approximation; the erf form (torch's
    # default) misses it by more than the tolerance, and so does an MLP
    # built on it
    x = np.linspace(-4, 4, 801).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    close(layers.gelu(t(x)), want, atol=1e-6)
    assert np.abs(F.gelu(t(x)).numpy() - want).max() > 10 * ATOL
    tree = r_layers.mlp_params(KEY, 64, 96, "gelu", jnp.float32)
    p = load(layers.MLP(64, 96, "gelu", **kw()), tree)
    h = normal(np.random.default_rng(14), 4, 64, scale=2.0)
    want = np.asarray(r_layers.mlp(tree, jnp.asarray(h), "gelu"))
    monkeypatch.setattr(layers, "gelu", F.gelu)
    got = layers.mlp(p, t(h), "gelu").detach().numpy()
    assert np.abs(got - want).max() > ATOL


@pytest.mark.parametrize("tie,cap", [(False, 0.0), (True, 30.0)])
def test_embed_and_unembed_match_reference(tie, cap):
    rng = np.random.default_rng(4)
    tree = r_layers.embed_params(KEY, 128, 32, jnp.float32, tie)
    p = load(layers.Embed(128, 32, tie, **kw()), tree)
    toks = rng.integers(0, 128, (2, 9)).astype(np.int32)
    close(layers.embed(p.embedding, t(toks)),
          r_layers.embed(tree, jnp.asarray(toks)))
    x = normal(rng, 2, 9, 32, scale=30.0)
    close(layers.unembed(p, t(x), cap),
          r_layers.unembed(tree, jnp.asarray(x), cap), atol=1e-4)


def test_sinusoidal_positions_and_cross_entropy_match_reference():
    assert np.array_equal(layers.sinusoidal_positions(50, 24),
                          r_layers.sinusoidal_positions(50, 24))
    rng = np.random.default_rng(5)
    logits = normal(rng, 2, 6, 40, scale=3.0)
    labels = rng.integers(0, 40, (2, 6)).astype(np.int32)
    labels[0, 2] = -100
    close(layers.cross_entropy(t(logits), t(labels)),
          r_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_cfg(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=64, head_dim=16)
    base.update(kw)
    return configs.ModelConfig(**base), ref_configs.ModelConfig(**base)


def _attn_pair(cfg, qkv_bias=False, seed=0):
    tree = r_attn.attn_params(jax.random.PRNGKey(seed), cfg.d_model,
                              cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              jnp.float32, qkv_bias)
    if qkv_bias:   # the reference's biases start at zero: make them count
        rng = np.random.default_rng(seed)
        tree = {k: (jnp.asarray(normal(rng, *v.shape, scale=0.3))
                    if k.startswith("b") else v) for k, v in tree.items()}
    p = load(attention.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim, qkv_bias=qkv_bias, **kw()),
             tree)
    return tree, p


@pytest.mark.parametrize("window,q_chunk,w_bf16,qkv_bias", [
    (0, 0, False, True),      # causal, with QKV biases
    (5, 0, False, False),     # banded
    (0, 8, False, False),     # q-chunked causal
    (6, 8, False, False),     # q-chunked banded: skips key blocks
    (0, 8, True, False),      # q-chunked, bf16 softmax weights
])
def test_attention_matches_reference(window, q_chunk, w_bf16, qkv_bias):
    cfg, rcfg = _attn_cfg(attn_q_chunk=q_chunk, attn_w_bf16=w_bf16)
    tree, p = _attn_pair(cfg, qkv_bias)
    rng = np.random.default_rng(6)
    x = normal(rng, 2, 32, 64)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    got, (k, v) = attention.attention(p, t(x), t(pos), cfg, window=window)
    want, (rk, rv) = r_attn.attention(tree, jnp.asarray(x), jnp.asarray(pos),
                                      rcfg, window=window)
    close(got, want)
    close(k, rk)
    close(v, rv)


def test_non_causal_cross_attention_matches_reference():
    cfg, rcfg = _attn_cfg()
    tree, p = _attn_pair(cfg)
    rng = np.random.default_rng(7)
    x, enc = normal(rng, 2, 5, 64), normal(rng, 2, 11, 64)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    got, _ = attention.attention(p, t(x), t(pos), cfg, x_kv=t(enc),
                                 causal=False, rope=False)
    want, _ = r_attn.attention(tree, jnp.asarray(x), jnp.asarray(pos), rcfg,
                               x_kv=jnp.asarray(enc), causal=False,
                               rope=False)
    close(got, want)


@pytest.mark.parametrize("window,positions", [
    (0, [0, 3, 9, 15]),        # per-slot positions, a slot at the last row
    (0, [2, 16, 17, 40]),      # past the last row: the write is dropped
    (8, [1, 7, 8, 29]),        # a ring of 8: filling, full, wrapped twice
])
def test_decode_attention_matches_reference(window, positions):
    cfg, rcfg = _attn_cfg()
    tree, p = _attn_pair(cfg)
    rng = np.random.default_rng(8)
    C = window or 16
    k, v = normal(rng, 4, C, 2, 16), normal(rng, 4, C, 2, 16)
    x = normal(rng, 4, 1, 64)
    pos = np.asarray(positions, np.int32)
    cache = attention.KVCache(t(k), t(v))
    got, new = attention.decode_attention(p, t(x), t(pos), cache, cfg,
                                          window=window)
    want, rnew = r_attn.decode_attention(
        tree, jnp.asarray(x), jnp.asarray(pos),
        r_attn.KVCache(jnp.asarray(k), jnp.asarray(v)), rcfg, window=window)
    close(got, want)
    close(new.k, rnew.k)
    close(new.v, rnew.v)
    assert np.array_equal(cache.k.numpy(), k)        # the input is not written


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,E,k,capacity", [(32, 4, 2, 6), (7, 8, 3, 2),
                                            (16, 4, 1, 16)])
def test_route_topk_matches_reference(T, E, k, capacity):
    rng = np.random.default_rng(T * E)
    logits = normal(rng, T, E, scale=2.0)
    got = moe.route_topk(t(logits), k, capacity)
    want = r_moe.route_topk(jnp.asarray(logits), k, capacity)
    for key in ("expert", "slot", "keep", "slot_token"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    close(got["gate"], want["gate"], atol=1e-6)
    close(got["aux"], want["aux"], atol=1e-6)
    if capacity < T * k // E:
        assert not got["keep"].all()                 # overflow was dropped


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"])
def test_moe_layer_matches_reference(name):
    cfg = configs.get_arch(name, smoke=True)
    rcfg = ref_configs.get_arch(name, smoke=True)
    tree = r_moe.moe_params(KEY, rcfg, jnp.float32)
    p = load(moe.MoE(cfg, **kw()), tree)
    x = normal(np.random.default_rng(9), 2, 12, cfg.d_model)
    y, aux = moe.moe_layer(p, cfg, t(x))
    ry, raux = r_moe.moe_layer(tree, rcfg, jnp.asarray(x))
    close(y, ry)
    close(aux, raux, atol=1e-6)


# ---------------------------------------------------------------------------
# the converter, and where the weights are drawn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["granite-3-2b", "recurrentgemma-2b",
                                  "whisper-tiny"])
def test_converter_is_a_leaf_for_leaf_copy(name):
    cfg, _, params, port = P.models(name)
    sd = port.state_dict()
    tree = P.np_tree(params)
    n_ref = sum(np.asarray(a).size for _, a in P.leaves(tree))
    assert sum(v.numel() for v in sd.values()) == n_ref
    got = convert.lm_params_from_numpy(cfg, tree)
    assert set(got) == set(sd)
    for k, v in got.items():
        assert v.dtype == sd[k].dtype and torch.equal(v, sd[k]), k


def test_build_model_draws_seeded_weights_on_the_given_device():
    cfg = configs.get_arch("granite-3-2b", smoke=True)
    a = build_model(cfg, device="cpu", seed=3)
    b = build_model(cfg, device="cpu", seed=3)
    c = build_model(cfg, device="cpu", seed=4)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert va.device.type == "cpu"
        assert torch.equal(va, vb), k
    assert not torch.equal(a.blocks[0].attn.wq, c.blocks[0].attn.wq)
    bf = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    assert bf.blocks[0].attn.wq.dtype == torch.bfloat16


def test_build_model_without_a_device_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py covers it")
    cfg = configs.get_arch("granite-3-2b", smoke=True)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_model(cfg)
