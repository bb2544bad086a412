"""The port's recurrent layers and its encoder-decoder against the
reference's on the CPU: the chunked SSD scan with a carried state and the
Mamba2 block's prefill and decode, the RG-LRU log-depth scan against its
step and the reference's associative scan, the Griffin recurrent block,
Whisper's decode against its full decoder, and each decoding family's
decode against its own full forward.

Inputs come from numpy seeds; weights are the reference's, loaded into the
port's modules. Tolerance: a layer's float32 output of order 1 within
``ATOL`` (2e-5), states and scans of order 10 within 1e-4, logits within
``lm_parity.LOGIT_ATOL`` (1e-4), a decode against its own full forward
within 5e-5 (the reference's bar for the same check).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as P
from lm_parity import KEY, close, kw, load, normal, t
from repro import configs as ref_configs
from repro.models import rglru as r_rglru
from repro.models import ssm as r_ssm
from repro_torch import configs
from repro_torch.models import build_model, rglru, ssm


# ---------------------------------------------------------------------------
# SSD, RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,chunk,carried", [(64, 16, True), (32, 32, False),
                                             (48, 8, True)])
def test_ssd_scan_matches_reference(L, chunk, carried):
    cfg = configs.get_arch("mamba2-780m", smoke=True)
    cfg = dataclasses.replace(cfg, ssm_chunk=chunk, ssm_groups=2)
    rcfg = dataclasses.replace(ref_configs.get_arch("mamba2-780m", smoke=True),
                               ssm_chunk=chunk, ssm_groups=2)
    rng = np.random.default_rng(L + chunk)
    H, P_, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, 2
    x = normal(rng, 2, L, H, P_)
    dt = np.abs(normal(rng, 2, L, H, scale=0.1))
    B, C = normal(rng, 2, L, G, N), normal(rng, 2, L, G, N)
    a_log = np.log(np.linspace(1.0, 16.0, H)).astype(np.float32)
    h0 = normal(rng, 2, H, P_, N) if carried else None
    y, h = ssm.ssd_scan(cfg, t(x), t(dt), t(B), t(C), t(a_log),
                        None if h0 is None else t(h0))
    ry, rh = r_ssm.ssd_scan(rcfg, *(jnp.asarray(a) for a in
                                    (x, dt, B, C, a_log)),
                            init_state=None if h0 is None else jnp.asarray(h0))
    close(y, ry, atol=1e-4)
    close(h, rh, atol=1e-4)


def test_ssd_scan_keeps_the_chunk_divisibility_assert():
    cfg = dataclasses.replace(configs.get_arch("mamba2-780m", smoke=True),
                              ssm_chunk=16)
    z = torch.zeros
    with pytest.raises(AssertionError):
        ssm.ssd_scan(cfg, z(1, 24, 8, 32), z(1, 24, 8), z(1, 24, 1, 16),
                     z(1, 24, 1, 16), z(8))


def test_ssd_block_prefill_and_decode_match_reference():
    cfg = configs.get_arch("mamba2-780m", smoke=True)
    rcfg = ref_configs.get_arch("mamba2-780m", smoke=True)
    tree = r_ssm.ssd_params(KEY, rcfg, jnp.float32)
    p = load(ssm.SSD(cfg, **kw()), tree)
    rng = np.random.default_rng(10)
    x = normal(rng, 2, 32, cfg.d_model)
    y, (conv, h) = ssm.ssd_block(p, cfg, t(x))
    ry, (rconv, rh) = r_ssm.ssd_block(tree, rcfg, jnp.asarray(x))
    close(y, ry)
    close(conv, rconv)
    close(h, rh, atol=1e-4)
    x1 = normal(rng, 2, 1, cfg.d_model)
    y1, (c1, h1) = ssm.ssd_block(p, cfg, t(x1), conv_state=conv,
                                 ssm_state=h, decode=True)
    ry1, (rc1, rh1) = r_ssm.ssd_block(tree, rcfg, jnp.asarray(x1),
                                      conv_state=rconv, ssm_state=rh,
                                      decode=True)
    close(y1, ry1)
    close(c1, rc1)
    close(h1, rh1, atol=1e-4)


@pytest.fixture(scope="module")
def lru():
    cfg = configs.get_arch("recurrentgemma-2b", smoke=True)
    rcfg = ref_configs.get_arch("recurrentgemma-2b", smoke=True)
    tree = r_rglru.rglru_params(KEY, rcfg, jnp.float32)
    return cfg, tree, load(rglru.RGLRU(cfg, **kw()), tree)


@pytest.mark.parametrize("L", [1, 5, 16, 37])
def test_rglru_scan_matches_its_step_and_the_reference(lru, L):
    # the log-depth scan sums in another order than a step loop and the
    # reference's associative scan: held within float32 tolerance
    cfg, tree, p = lru
    rng = np.random.default_rng(L)
    x = normal(rng, 2, L, cfg.lru_width)
    h0 = normal(rng, 2, cfg.lru_width)
    y, h_last = rglru.rglru(p, t(x), t(h0))
    ry, rh = r_rglru.rglru(tree, jnp.asarray(x), jnp.asarray(h0))
    close(y, ry)
    close(h_last, rh)
    h, steps = t(h0), []
    for i in range(L):
        yi, h = rglru.rglru_step(p, t(x[:, i:i + 1]), h)
        steps.append(yi)
    close(y, torch.cat(steps, 1).numpy())
    close(h_last, h.numpy())


def test_recurrent_block_matches_reference(lru):
    cfg, tree, p = lru
    rng = np.random.default_rng(11)
    x = normal(rng, 2, 12, cfg.d_model)
    y, (conv, h) = rglru.recurrent_block(p, t(x))
    ry, (rconv, rh) = r_rglru.recurrent_block(tree, jnp.asarray(x))
    close(y, ry)
    close(conv, rconv)
    close(h, rh)
    x1 = normal(rng, 2, 1, cfg.d_model)
    y1, st = rglru.recurrent_block(p, t(x1), conv_state=conv, h_state=h,
                                   decode=True)
    ry1, rst = r_rglru.recurrent_block(tree, jnp.asarray(x1),
                                       conv_state=rconv, h_state=rh,
                                       decode=True)
    close(y1, ry1)
    close(st[0], rst[0])
    close(st[1], rst[1])


# ---------------------------------------------------------------------------
# Whisper: decode against the full decoder; the model's decode against its
# own full forward (the reference's test_decode_matches_full_forward)
# ---------------------------------------------------------------------------

def test_whisper_decode_matches_its_full_decoder_and_the_reference():
    cfg, ref, params, port = P.models("whisper-tiny")
    b = P.batch(cfg, 12, B=2, S=10)
    with torch.inference_mode():
        enc = port.encode(P.to_torch(b)["frames"])
        full, _ = port.decode_full(t(b["tokens"]), enc)
        caches = port.init_decode_caches(2, 16)
        caches["enc_out"] = enc
        outs = []
        for i in range(10):
            lg, caches = port.decode_step(caches, t(b["tokens"][:, i:i + 1]),
                                          i)
            outs.append(lg[:, 0])
    close(torch.stack(outs, 1), full.numpy(), atol=5e-5)
    renc = ref.encode(params, jnp.asarray(b["frames"]))
    close(enc, renc, atol=1e-5)
    rfull, _ = ref.decode_full(params, jnp.asarray(b["tokens"]), renc)
    close(full, rfull, atol=P.LOGIT_ATOL)


@pytest.mark.parametrize("name", ["yi-6b", "deepseek-moe-16b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_port_decode_matches_its_full_forward(name):
    cfg = configs.get_arch(name, smoke=True)
    if cfg.n_experts:
        # dropless capacity: overflow drops depend on the batch size
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    model = build_model(cfg, device="cpu")
    rng = np.random.default_rng(13)
    toks = t(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int64))
    with torch.inference_mode():
        full = model.forward({"tokens": toks})
        caches = model.init_decode_caches(2, 16)
        outs = []
        for i in range(16):
            lg, caches = model.decode_step(caches, toks[:, i:i + 1], i)
            outs.append(lg[:, 0])
    close(torch.stack(outs, 1), full.numpy(), atol=5e-5)
