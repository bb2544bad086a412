"""Each of the ten architectures' smoke configs, the port's decode against
the reference's on the CPU with the same weights: two ``decode_step``s
from zero caches at per-slot positions (logits and caches), and decoding
on from the reference's prefill caches carried over by
``convert.lm_caches_from_numpy``.

Tolerance (``lm_parity``): logits within ``LOGIT_ATOL`` (1e-4) in float32,
caches and states within ``CACHE_ATOL``/``CACHE_RTOL``, the same nesting,
keys, shapes and dtypes.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_parity as P
from repro.configs import ARCHS
from repro_torch import convert

NAMES = sorted(ARCHS)


def _close(got, want, atol=P.LOGIT_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_two_decode_steps_match_reference(name):
    cfg, ref, params, port = P.models(name)
    rng = np.random.default_rng(2)
    rc = ref.init_decode_caches(2, 32)
    pc = port.init_decode_caches(2, 32)
    P.assert_trees_close(convert.lm_caches_to_numpy(pc), P.np_tree(rc))
    step = P.jitted(name, "decode_step")
    for pos in ([0, 3], [1, 4]):     # each slot at its own position
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        rl, rc = step(params, rc, jnp.asarray(tok), jnp.asarray(pos))
        with torch.inference_mode():
            pl, pc = port.decode_step(pc, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        assert pl.shape == (2, 1, cfg.padded_vocab)
        _close(pl, rl)
    P.assert_trees_close(convert.lm_caches_to_numpy(pc), P.np_tree(rc))


@pytest.mark.parametrize("name", ["granite-3-2b", "mamba2-780m",
                                  "recurrentgemma-2b", "whisper-tiny"])
def test_decode_continues_from_the_references_prefill_caches(name):
    # the caches cross over through the converter and decoding goes on
    # from them as the reference does (a scalar position)
    cfg, _, params, port = P.models(name)
    b = P.batch(cfg, 3, S=8)
    _, rcaches = P.jitted(name, "prefill")(params, P.to_jax(b))
    if cfg.family in ("dense", "audio"):
        # room for the next position: the prefill caches hold 8 rows
        pad = lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)])  # noqa: E731
        if cfg.family == "dense":
            rcaches["kv"] = type(rcaches["kv"])(*map(pad, rcaches["kv"]))
        else:
            self_kv, cross = rcaches["dec"]
            rcaches["dec"] = (type(self_kv)(*map(pad, self_kv)), cross)
    pc = convert.lm_caches_from_numpy(P.np_tree(rcaches))
    P.assert_trees_close(convert.lm_caches_to_numpy(pc), P.np_tree(rcaches),
                         atol=0, rtol=0)
    tok = np.full((2, 1), 7, np.int32)
    rl, _ = P.jitted(name, "decode_step")(params, rcaches, jnp.asarray(tok))
    with torch.inference_mode():
        pl, new = port.decode_step(pc, torch.from_numpy(tok))
    _close(pl, rl)
    assert new["pos"] == 9
