"""Each of the ten architectures' smoke configs, the port's model against
the reference's on the CPU with the same weights: ``forward``, ``loss``
and ``prefill`` (logits and caches). Decode steps are held in
``test_torch_lm_decode.py``.

Tolerance (``lm_parity``): logits within ``LOGIT_ATOL`` (1e-4) in float32,
caches and states within ``CACHE_ATOL``/``CACHE_RTOL``, the same nesting,
keys, shapes and dtypes.
"""
from __future__ import annotations

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
def test_forward_and_loss_match_reference(name):
    cfg, _, params, port = P.models(name)
    b = P.batch(cfg, 0)
    with torch.inference_mode():
        got = port.forward(P.to_torch(b))
        loss, metrics = port.loss(P.to_torch(b))
    want = P.jitted(name, "forward")(params, P.to_jax(b))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)
    rloss, rmetrics = P.jitted(name, "loss")(params, P.to_jax(b))
    _close(loss, rloss)
    _close(metrics["aux"], rmetrics["aux"], atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_reference(name):
    cfg, _, params, port = P.models(name)
    b = P.batch(cfg, 1)
    with torch.inference_mode():
        logits, caches = port.prefill(P.to_torch(b))
    rlogits, rcaches = P.jitted(name, "prefill")(params, P.to_jax(b))
    _close(logits, rlogits)
    P.assert_trees_close(convert.lm_caches_to_numpy(caches),
                         P.np_tree(rcaches))
