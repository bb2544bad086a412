"""Shared fixtures of the LM stack's parity tests: the reference's and the
port's model of one smoke config with the same weights, inputs made from
numpy seeds, tree comparisons, single modules loaded with the
reference's parameters, and the two engines side by side.

The reference draws its weights (``model.init(PRNGKey(0))``) and the port
loads them through ``convert.lm_params_from_numpy``; both run on the CPU in
float32. Tolerances: logits within ``LOGIT_ATOL``; tokens equal, with the
reference's top-2 logit margin above ``MARGIN`` at every greedy pick, so
that a near-tie shows as such and not as a flip.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request

LOGIT_ATOL = 1e-4
# the caches and states hold values of order 1 to 10
CACHE_ATOL, CACHE_RTOL = 1e-4, 1e-5
MARGIN = 10 * LOGIT_ATOL
# one layer's float32 output, of order 1
ATOL = 2e-5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def models(name: str):
    """(cfg, reference model, reference params, port model) of ``name``'s
    smoke config; the port holds the reference's weights."""
    cfg = ref_get_arch(name, smoke=True)
    pcfg = get_arch(name, smoke=True)
    ref = ref_build_model(cfg)
    params = ref.init(jax.random.PRNGKey(0))
    port = build_model(pcfg, device="cpu")
    port.load_state_dict(convert.lm_params_from_numpy(pcfg, np_tree(params)))
    port.requires_grad_(False)
    return cfg, ref, params, port


@functools.lru_cache(maxsize=None)
def jitted(name: str, method: str):
    return jax.jit(getattr(models(name)[1], method))


def batch(cfg, seed: int, B: int = 2, S: int = 16) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": toks}
    if cfg.family == "audio":
        out["frames"] = (0.1 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def leaves(tree, path=""):
    """(path, leaf) in a fixed order over dicts (by key), lists and
    tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_trees_close(got, want, atol=CACHE_ATOL, rtol=CACHE_RTOL):
    """``got`` (the port's caches as numpy) against ``want`` (the
    reference's): the same nesting, shapes and dtypes, values within the
    tolerance."""
    g, w = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=path)


def top2_margin(logits) -> np.ndarray:
    """The gap between the largest and the second largest logit of each
    row of ``logits`` (..., V)."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)
    return top[..., -1] - top[..., -2]


# ---------------------------------------------------------------------------
# one module at a time
# ---------------------------------------------------------------------------

KEY = jax.random.PRNGKey(0)


def load(module, tree):
    """``module`` holding the reference's parameter ``tree``."""
    module.load_state_dict({n: convert._tensor(a, "cpu") for n, a in
                            convert._leaves(np_tree(tree), "")})
    return module.requires_grad_(False)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=atol, rtol=0)


def normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def kw(seed=0):
    return dict(dtype=torch.float32, device="cpu",
                generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# the two engines side by side
# ---------------------------------------------------------------------------

class RecordingEngine(RefEngine):
    """The reference's engine, recording the top-2 logit margin of every
    pick it makes (prefill and active decode rows)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.margins: list[float] = []
        decode = jax.jit(self._decode_with_logits)
        prefill = self._prefill

        def recorded_decode(params, caches, toks, pos, act):
            nxt, caches, logits = decode(params, caches, toks, pos, act)
            m = top2_margin(np.asarray(logits)[:, 0])
            self.margins += m[np.asarray(act)].tolist()
            return nxt, caches

        def recorded_prefill(params, toks):
            logits, caches = prefill(params, toks)
            self.margins += top2_margin(np.asarray(logits)).tolist()
            return logits, caches

        self._decode = recorded_decode
        self._prefill = recorded_prefill

    def _decode_with_logits(self, params, caches, tokens, positions, active):
        logits, caches = self.model.decode_step(params, caches,
                                                tokens[:, None], positions)
        nxt = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
        return jnp.where(active, nxt, 0), caches, logits


def engines(name, **kw):
    _, ref, params, port = models(name)
    return RecordingEngine(ref, params, **kw), Engine(port, **kw)


def both(engs, method, *args, **kw):
    return [getattr(e, method)(*args, **kw) for e in engs]


def submit(engs, rid, prompt, **kw):
    """The same request to both engines; their answers must agree."""
    ref, port = engs
    got = (ref.submit(RefRequest(rid=rid, prompt=prompt, **kw)),
           port.submit(Request(rid=rid, prompt=prompt, **kw)))
    assert got[0] == got[1]
    return got[0]


def run(engs, **kw):
    """``run_until_done`` on both; the outputs, finish reasons, steps and
    active widths must be equal and every pick clear of a near-tie."""
    ref_out, out = both(engs, "run_until_done", **kw)
    ref, port = engs
    assert out == ref_out
    assert port.finish_reasons() == ref.finish_reasons()
    assert port.steps_run == ref.steps_run
    assert port.active_history == ref.active_history
    assert min(ref.margins, default=np.inf) > MARGIN
    return out


def prompt(cfg, rng, n):
    return rng.integers(0, cfg.vocab_size, n)
