"""Multi-rank checks of the port's mesh layer: each sharded path held
against the port's own unsharded one on gloo ranks on the host.

    PYTHONPATH=src python tests/mesh_check.py --world 4 --out DIR \\
        [--cases train_step,decode,elastic,compressed_dp,pipeline]

starts ``--world`` ranks (``repro_torch.launch.mesh.run_world``:
``spawn``, a ``FileStore`` in ``DIR``, one intra-op thread a rank, a 60 s
collective timeout) that run the named cases in order. Rank 0 rewrites
``DIR/results.json`` after each case with its numbers; a case that fails
raises on its rank, which ends the world and the command (exit code
not 0). ``run`` starts that command from another process (the multi-rank
tests, ``chip_smoke.py``'s lm-mesh phase): nothing here joins the
caller's process to a world.

The bars are those of the sharded cases the mesh layer is modelled on,
at granite-3-2b smoke width, batch 8 x 32 (the pipeline: 8 toy layers of
width 16, 4 microbatches of 2):
  * train_step: on (1, W) the sharded step is the unsharded one bit for
    bit (loss, gradient norm, params, mu, nu); on (2, W/2) and (W, 1) the
    loss within 1e-5 and every parameter within 1e-4;
  * decode: two sharded decode steps against unsharded ones, logits and
    new caches ``==`` on (1, W), within 3e-5 on (2, W/2);
  * prefill: the sharded prefill step on (2, W/2) and (W, 1), with
    ``last_only`` off and on, its logits (gathered on every rank) within
    3e-5 of the unsharded forward's; rank 0 writes them and the tokens to
    ``DIR/prefill_<shape>_<all|last>.npz`` for a comparison with the
    reference's forward elsewhere;
  * elastic: a state stepped on (2, W/2), saved, restored onto (W, 1),
    (1, W) and unsharded, every leaf bit-identical; a step's loss from
    the (W, 1) restore within 1e-5 of the unsharded restore's;
  * compressed_dp: on a (W,) "data" mesh the int8-EF step's loss within
    1e-4 of the plain step's, the parameters within 5e-3, and 5 more
    steps on the same batch lower the loss by more than 0.01;
  * pipeline: a W-stage pipeline within 1e-5 of ``sequential_apply`` and
    its parameter gradients within 1e-4;
  * psum: ``compressed_psum`` on ``psum_inputs(world)``, each rank's
    payload sums, mean and residuals written to ``DIR/psum_<rank>.npz``
    for a comparison elsewhere;
  * collectives: ``roofline.analysis.collective_bytes`` over one call of
    each kind of ``collective_cases``, the bytes it counted beside the
    bytes counted by hand (compared elsewhere).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-4
DECODE_ATOL = 3e-5
DP_LOSS_ATOL = 1e-4
DP_PARAM_ATOL = 5e-3
DP_DROP = 0.01
PP_ATOL = 1e-5
PP_GRAD_ATOL = 1e-4

CASES = ("train_step", "decode", "prefill", "elastic", "compressed_dp",
         "pipeline")


def _setup():
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.data import PipelineSpec, make_batch

    cfg = get_arch("granite-3-2b", smoke=True)
    rc = RunConfig(learning_rate=1e-3, warmup_steps=0, weight_decay=0.0)
    spec = PipelineSpec(vocab=cfg.vocab_size, seq_len=32, global_batch=8,
                        seed=0)
    return cfg, rc, make_batch(cfg, spec, 0, device="cpu")


def _model(cfg):
    from repro_torch.models import build_model

    return build_model(cfg, device="cpu", seed=0)


def _mesh(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes, "cpu")


def _placed_state(model, rc, mesh):
    from repro_torch.train import init_state
    from repro_torch.launch.shardings import place, state_shardings

    state = init_state(model, rc)
    return place(state, state_shardings(mesh, state, model.cfg))


def _trees(state) -> dict:
    """The state's params, mu and nu as global tensors, by kind and name."""
    from repro_torch.launch.shardings import full

    return {f"{kind} {k}": full(t).detach().clone()
            for kind, tree in (("params", state.params),
                               ("mu", state.opt.mu), ("nu", state.opt.nu))
            for k, t in tree.items()}


def _same(name: str, got: dict, want: dict) -> None:
    for k, w in want.items():
        if got[k].dtype != w.dtype or not torch.equal(got[k], w):
            raise AssertionError(f"{name}: {k} differs")


def _max_diff(got: dict, want: dict, prefix: str = "") -> float:
    return max(float((got[k].float() - w.float()).abs().max())
               for k, w in want.items() if k.startswith(prefix))


def _shapes(world: int) -> list[tuple[int, int]]:
    return [(1, world), (2, world // 2), (world, 1)] if world % 2 == 0 \
        else [(1, world), (world, 1)]


def case_train_step(world: int, out: str) -> dict:
    from repro_torch.train import init_state, make_sharded_train_step, make_train_step
    from repro_torch.launch.shardings import full, local_slice, place, state_shardings

    cfg, rc, batch = _setup()
    model = _model(cfg)
    st, m = make_train_step(model, rc, 100)(init_state(model, rc), batch)
    want, want_loss = _trees(st), float(m["loss"])
    res = {}
    for shape in _shapes(world):
        mesh = _mesh(shape)
        model = _model(cfg)
        state = init_state(model, rc)
        shardings = state_shardings(mesh, state, cfg)
        state = place(state, shardings)
        held = sum(t.to_local().numel() for t in state.params.values())
        total = sum(t.numel() for t in state.params.values())
        for k, t in state.params.items():
            cut = local_slice(full(t), mesh, shardings.params[k].spec)
            if not torch.equal(cut, t.to_local()):
                raise AssertionError(f"local_slice of {k} is not its shard")
        st2, m2 = make_sharded_train_step(model, rc, mesh, 100)(state, batch)
        got = _trees(st2)
        key = "x".join(map(str, shape))
        if shape[0] == 1:
            _same(f"sharded step on {key}", got, want)
            if not (torch.equal(m2["loss"], m["loss"])
                    and torch.equal(m2["grad_norm"], m["grad_norm"])):
                raise AssertionError(f"{key}: loss or grad norm differs")
        loss_err = abs(float(m2["loss"]) - want_loss)
        p_err = _max_diff(got, want, "params")
        if not (loss_err < LOSS_ATOL and p_err < PARAM_ATOL):
            raise AssertionError(f"{key}: loss differs by {loss_err}, "
                                 f"params by {p_err}")
        res[key] = {"loss_err": loss_err, "param_err": p_err,
                    "held_share": held / total}
    return res


def case_decode(world: int, out: str) -> dict:
    from repro_torch.serve.sharded import make_sharded_decode_step
    from repro_torch.launch.shardings import cache_shardings, full, param_shardings, place
    from repro_torch.launch.shardings import tree_map

    cfg, _, _ = _setup()
    model = _model(cfg)
    B = 8
    caches = model.init_decode_caches(B, 64)
    tok = (torch.arange(B, dtype=torch.int32).reshape(B, 1)
           % cfg.vocab_size)
    with torch.no_grad():
        want1, c1 = model.decode_step(caches, tok, 0)
        want2, c2 = model.decode_step(c1, tok + 1, 1)
    res = {}
    for shape in _shapes(world)[:2]:
        mesh = _mesh(shape)
        m2 = _model(cfg)
        params = place(dict(m2.named_parameters()),
                       param_shardings(mesh, dict(m2.named_parameters()),
                                       cfg))
        placed = place(caches, cache_shardings(mesh, caches, B))
        step = make_sharded_decode_step(m2, mesh)
        got1, p1 = step(params, placed, tok, 0)
        got2, p2 = step(params, p1, tok + 1, 1)
        key = "x".join(map(str, shape))
        pairs = [(got1, want1), (got2, want2),
                 *zip(_flat(tree_map(full, p2)), _flat(c2))]
        err = max(float((g - w).abs().max()) for g, w in pairs)
        if shape[0] == 1 and err != 0.0:
            raise AssertionError(f"decode on {key} differs by {err}")
        if err > DECODE_ATOL:
            raise AssertionError(f"decode on {key} differs by {err}")
        res[key] = {"max_abs_err": err}
    return res


def case_prefill(world: int, out: str) -> dict:
    import torch.distributed as dist

    from repro_torch.serve.sharded import make_sharded_prefill_step
    from repro_torch.launch.shardings import param_shardings, place

    cfg, _, batch = _setup()
    batch = {"tokens": batch["tokens"]}
    model = _model(cfg)
    res = {}
    for last_only in (False, True):
        with torch.no_grad():
            want = model.forward(batch, last_only=last_only)
        for shape in _shapes(world)[1:]:
            mesh = _mesh(shape)
            m2 = _model(cfg)
            own = dict(m2.named_parameters())
            params = place(own, param_shardings(mesh, own, cfg))
            got = make_sharded_prefill_step(m2, mesh, last_only)(params,
                                                                 batch)
            key = "x".join(map(str, shape)) + ("_last" if last_only
                                               else "_all")
            if got.shape != want.shape:
                raise AssertionError(f"prefill on {key}: {tuple(got.shape)}"
                                     f" != {tuple(want.shape)}")
            err = float((got - want).abs().max())
            if err > DECODE_ATOL:
                raise AssertionError(f"prefill on {key} differs by {err}")
            if dist.get_rank() == 0:
                np.savez(os.path.join(out, f"prefill_{key}.npz"),
                         logits=got.numpy(),
                         tokens=batch["tokens"].numpy())
            res[key] = {"max_abs_err": err}
    return res


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def case_elastic(world: int, out: str) -> dict:
    from repro_torch.checkpoint import ckpt
    from repro_torch.train import init_state, make_sharded_train_step, make_train_step
    from repro_torch.launch.shardings import state_shardings

    cfg, rc, batch = _setup()
    if world % 2:
        raise ValueError("the elastic case saves on (2, world / 2)")
    mesh_a = _mesh((2, world // 2))
    model = _model(cfg)
    state, _ = make_sharded_train_step(model, rc, mesh_a, 100)(
        _placed_state(model, rc, mesh_a), batch)
    saved = _trees(state)
    d = os.path.join(out, "elastic_ckpt")
    ckpt.save(d, 1, state, {"step": 1})
    res = {}
    for shape in ((world, 1), (1, world)):
        mesh_b = _mesh(shape)
        model_b = _model(cfg)
        like = init_state(model_b, rc)
        target = state_shardings(mesh_b, like, cfg)
        restored, _ = ckpt.restore(d, like, shardings=target)
        for k, t in restored.opt.mu.items():
            if tuple(t.placements) != target.opt.mu[k].placements:
                raise AssertionError(f"mu {k} restored as {t.placements}")
        _same(f"restored onto {shape}", _trees(restored), saved)
        if shape == (world, 1):
            _, m_b = make_sharded_train_step(model_b, rc, mesh_b, 100)(
                restored, batch)
    model_1 = _model(cfg)
    restored_1, _ = ckpt.restore(d, init_state(model_1, rc))
    _same("restored unsharded", _trees(restored_1), saved)
    with torch.no_grad():
        for k, p in model_1.named_parameters():
            p.copy_(restored_1.params[k])
    _, m_1 = make_train_step(model_1, rc, 100)(
        restored_1._replace(params=dict(model_1.named_parameters())), batch)
    err = abs(float(m_b["loss"]) - float(m_1["loss"]))
    if not err < LOSS_ATOL:
        raise AssertionError(f"step after restore: losses differ by {err}")
    res["loss_err"] = err
    return res


def case_compressed_dp(world: int, out: str) -> dict:
    from repro_torch.train import init_state, make_compressed_dp_step, make_train_step

    cfg, rc, batch = _setup()
    mesh = _mesh((world,), ("data",))
    plain = _model(cfg)
    s_ref, m_ref = make_train_step(plain, rc, 100)(init_state(plain, rc),
                                                   batch)
    model = _model(cfg)
    step = make_compressed_dp_step(model, rc, mesh, 100)
    s_c, m_c = step(init_state(model, rc), batch)
    loss_err = abs(float(m_ref["loss"]) - float(m_c["loss"]))
    p_err = max(float((s_c.params[k].detach() - p.detach()).abs().max())
                for k, p in s_ref.params.items())
    losses = [float(m_c["loss"])]
    s = s_c
    for _ in range(5):
        s, m = step(s, batch)
        losses.append(float(m["loss"]))
    if not (loss_err < DP_LOSS_ATOL and p_err < DP_PARAM_ATOL
            and losses[-1] < losses[0] - DP_DROP):
        raise AssertionError(f"compressed step: loss err {loss_err}, "
                             f"param err {p_err}, losses {losses}")
    return {"loss_err": loss_err, "param_err": p_err, "losses": losses}


def _layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def stage_fn(p, x):
    """A stage of toy layers: ``tanh(x @ w + b)`` for each of its layers."""
    for i in range(p["w"].shape[0]):
        x = _layer({"w": p["w"][i], "b": p["b"][i]}, x)
    return x


def pipeline_inputs(D: int = 16, L: int = 8, M: int = 4, B: int = 2,
                    seed: int = 0):
    """The toy layers' weights (L, D, D) at scale 1/sqrt(D), zero biases
    and microbatched input (M, B, D), float32 from a numpy generator."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, D, D)) / np.sqrt(D)).astype(np.float32)
    return {"w": w, "b": np.zeros((L, D), np.float32)}, \
        rng.standard_normal((M, B, D)).astype(np.float32)


def case_pipeline(world: int, out: str) -> dict:
    import torch.distributed as dist

    from repro_torch.train.pipeline import (make_pp_loss, pipeline_apply,
                                  sequential_apply, stack_stages)

    mesh = _mesh((world,), ("stage",))
    layers, x_np = pipeline_inputs()
    x = torch.from_numpy(x_np)

    def staged():
        return {k: v.requires_grad_() for k, v in stack_stages(
            {k: torch.from_numpy(v.copy()) for k, v in layers.items()},
            world).items()}

    seq_p = staged()
    ref = sequential_apply(stage_fn, seq_p, x)
    (ref ** 2).sum().backward()
    pp_p = staged()
    err = float((pipeline_apply(mesh, stage_fn, pp_p, x) - ref).detach()
                .abs().max())
    # the same loss through make_pp_loss: embed and head around the stages
    loss_fn = make_pp_loss(mesh, stage_fn, lambda other, b: b,
                           lambda other, y, b, labels: (y ** 2).sum(), world)
    loss_fn((pp_p, {}), x, None).backward()
    g = pp_p["w"].grad.clone()
    dist.all_reduce(g, group=mesh.group("stage"))
    g_err = float((g - seq_p["w"].grad).abs().max())
    if not (err < PP_ATOL and g_err < PP_GRAD_ATOL):
        raise AssertionError(f"pipeline: output differs by {err}, "
                             f"gradients by {g_err}")
    return {"max_abs_err": err, "grad_max_abs_err": g_err}


PSUM_SHAPES = {"a": (4, 33), "b": (7,), "c": (2, 3, 5)}


def psum_inputs(world: int, seed: int = 0):
    """Per-rank gradients and carried residuals, (world, *shape) float32
    each, from a numpy generator: gradients at scales 1e-3...1e2 so that
    the per-rank scales differ, residuals a small fraction of them."""
    rng = np.random.default_rng(seed)
    grads, errs = {}, {}
    for k, shape in PSUM_SHAPES.items():
        scale = 10.0 ** rng.uniform(-3, 2, (world,) + (1,) * len(shape))
        grads[k] = (rng.standard_normal((world, *shape)) * scale).astype(
            np.float32)
        errs[k] = (rng.standard_normal((world, *shape)) * scale
                   * 1e-3).astype(np.float32)
    return grads, errs


def case_psum(world: int, out: str) -> dict:
    import torch.distributed as dist

    from repro_torch.optim import compression

    rank = dist.get_rank()
    grads_np, errs_np = psum_inputs(world)
    grads = {k: torch.from_numpy(v[rank].copy()) for k, v in grads_np.items()}
    errs = {k: torch.from_numpy(v[rank].copy()) for k, v in errs_np.items()}
    qs, scales, _ = compression.compress(grads, compression.EFState(errs))
    sums = {k: compression.psum_payload(qs[k], scales[k])[0]
            for k in PSUM_SHAPES}
    mean, ef2 = compression.compressed_psum(
        {k: g.clone() for k, g in grads.items()},
        compression.EFState({k: e.clone() for k, e in errs.items()}))
    np.savez(os.path.join(out, f"psum_{rank}.npz"),
             **{f"sum/{k}": v.numpy() for k, v in sums.items()},
             **{f"mean/{k}": v.numpy() for k, v in mean.items()},
             **{f"ef/{k}": v.numpy() for k, v in ef2.error.items()})
    return {"leaves": len(PSUM_SHAPES)}


# collectives: (what, bytes of its output on each rank, counted by hand)
# for a world of W ranks
def collective_cases(world: int) -> dict[str, int]:
    return {"all_reduce f32 (3, 5)": 3 * 5 * 4,
            "all_gather_into_tensor f32 (2, 3) each": world * 2 * 3 * 4,
            "reduce_scatter_tensor f32 (W * 2,) in": 2 * 4,
            "broadcast i64 (7,)": 7 * 8,
            "DTensor full_tensor bf16 Shard(0) of (W * 4, 8)":
                world * 4 * 8 * 2}


def case_collectives(world: int, out: str) -> dict:
    """``roofline.analysis.collective_bytes`` over one call of each kind
    in ``collective_cases`` (each alone, then all together): the output
    bytes of each, counted once."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.roofline.analysis import collective_bytes

    mesh = _mesh((world,), ("data",))
    rank = dist.get_rank()
    calls = [
        lambda: dist.all_reduce(torch.ones(3, 5)),
        lambda: dist.all_gather_into_tensor(torch.empty(world * 2, 3),
                                            torch.full((2, 3), rank * 1.0)),
        lambda: dist.reduce_scatter_tensor(torch.empty(2),
                                           torch.ones(world * 2)),
        lambda: dist.broadcast(torch.arange(7), src=0),
        lambda: DTensor.from_local(
            torch.ones(4, 8, dtype=torch.bfloat16), mesh.device_mesh,
            [Shard(0)]).full_tensor(),
    ]
    got = {}
    for what, call in zip(collective_cases(world), calls):
        with collective_bytes() as cb:
            call()
        got[what] = {"bytes": cb.total, "calls": cb.calls}
    with collective_bytes() as cb:
        for call in calls:
            call()
    return {"each": got, "total": cb.total, "calls": cb.calls}


def _rank(rank: int, cases: list[str], world: int, out: str) -> None:
    results = {}
    for name in cases:
        t = time.perf_counter()
        results[name] = globals()[f"case_{name}"](world, out)
        results[name]["s"] = time.perf_counter() - t
        if rank == 0:
            with open(os.path.join(out, "results.json"), "w") as f:
                json.dump(results, f)
            print(f"PASS {name}", flush=True)


def main(argv=None) -> None:
    from repro_torch.launch.mesh import run_world

    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    unknown = [c for c in cases if f"case_{c}" not in globals()]
    if unknown:
        raise SystemExit(f"unknown cases {unknown}")
    os.makedirs(args.out, exist_ok=True)
    # by the module's own name: a spawned rank imports it (not __main__)
    import mesh_check

    run_world(mesh_check._rank, args.world, args.out, cases, args.world,
              args.out, backend="gloo")


def run(out: Path, cases: list[str], world: int = 4,
        timeout: float = 240.0) -> dict:
    """The results of ``cases`` on a world of ``world`` gloo ranks (this
    file as a command, in a session of its own that is killed whole if it
    outlives ``timeout``; no card visible to it), with the command's exit
    code, stdout and the end of its stderr under ``"_run"``."""
    here = Path(__file__).resolve()
    proc = subprocess.Popen(
        [sys.executable, str(here), "--world", str(world), "--out",
         str(out), "--cases", ",".join(cases)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=out, start_new_session=True,
        env={**os.environ, "PYTHONPATH": str(here.parents[1] / "src"),
             "CUDA_VISIBLE_DEVICES": ""})
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        stderr += f"\n(killed after {timeout} s)"
    results_file = out / "results.json"
    results = json.loads(results_file.read_text()) \
        if results_file.exists() else {}
    results["_run"] = {"rc": proc.returncode, "stdout": stdout,
                       "stderr": stderr[-4000:]}
    return results


def case(results: dict, name: str) -> dict:
    """One case's numbers; a case the world did not finish fails with the
    command's output."""
    assert name in results, f"{name} did not finish:\n{results['_run']}"
    return results[name]


if __name__ == "__main__":
    main()
