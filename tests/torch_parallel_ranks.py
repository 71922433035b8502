"""Rank processes of the gloo tests of the port's parallel execution
(tests/test_torch_parallel.py, tests/test_torch_parallel_loop.py).

This module imports no JAX: each rank runs the port alone, as a process
that ``torchrun`` would start. :func:`spawn` starts the ranks of one task
with ``torchrun``'s environment on the loopback address and gives each a
time limit; a rank that fails, or a deadlocked collective, fails the
calling test with the ranks' error output, and the ranks are killed.

    python tests/torch_parallel_ranks.py TASK FOLDER   (RANK, WORLD_SIZE, ... set)

reads ``FOLDER/payload.pkl`` and writes ``FOLDER/rank<r>.pkl``.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The rank processes of one task, started on ``world`` gloo ranks:
    :meth:`wait` returns each rank's result, or raises with the ranks'
    output when one fails or the time limit (counted from the start)
    passes, killing them all."""

    def __init__(self, task: str, world: int, payload: dict, folder: str,
                 timeout: float = 120.0, threads: int = 1):
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("PYTEST_", "JAX_", "XLA_"))}
        env.update(PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(world), OMP_NUM_THREADS=str(threads))
        self.folder, self.world = folder, world
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.logs = [open(os.path.join(folder, f"rank{r}.log"), "w") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, folder],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=folder,
            stdout=self.logs[r], stderr=subprocess.STDOUT) for r in range(world)]

    def wait(self) -> list:
        procs = self.procs
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > self.deadline or any(p.poll() not in (None, 0)
                                                           for p in procs):
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in self.logs:
                log.close()
        if any(p.returncode != 0 for p in procs):
            tails = []
            for r in range(self.world):
                with open(os.path.join(self.folder, f"rank{r}.log")) as f:
                    tails.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                                 f"{f.read()[-3000:]}")
            expired = "timed out after %.0f s\n" % self.timeout \
                if time.monotonic() > self.deadline else ""
            raise AssertionError(expired + "\n".join(tails))
        out = []
        for r in range(self.world):
            with open(os.path.join(self.folder, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def spawn(task: str, world: int, payload: dict, folder: str, timeout: float = 120.0,
          threads: int = 1) -> list:
    """Run ``task`` on ``world`` gloo ranks; returns each rank's result."""
    return Ranks(task, world, payload, folder, timeout, threads).wait()


# ---------------------------------------------------------------------------
# tasks (run inside the rank processes)
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().float().cpu().numpy()


class _Ctx:
    """One mesh's bookkeeping: its coordinates and the gathers the checks need."""

    def __init__(self, mesh):
        from deco_tpu_torch.parallel import mesh as mesh_lib

        self.mesh = mesh
        self.d = mesh_lib.axis_index(mesh, mesh_lib.DATA_AXIS)
        self.D = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
        self.m = mesh_lib.axis_index(mesh, mesh_lib.MODEL_AXIS)
        self.M = mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS)
        self.group = mesh_lib.axis_group(mesh, mesh_lib.MODEL_AXIS)

    def rows(self, a):
        b = a.shape[0] // self.D
        return a[self.d * b:(self.d + 1) * b]

    def chunk(self, a, dim=1):
        return a.chunk(self.M, dim=dim)[self.m]

    def stitch(self, local, seq_dim=None):
        """The global array from every rank's piece: data ranks along dim 0,
        model ranks along ``seq_dim`` (None: the model ranks hold the same)."""
        import numpy as np

        from deco_tpu_torch.parallel.distributed import process_allgather

        parts = process_allgather(_np(local))
        rows = []
        for d in range(self.D):
            own = parts[d * self.M:(d + 1) * self.M]
            rows.append(own[0] if seq_dim is None else np.concatenate(list(own), axis=seq_dim))
        return np.concatenate(rows, axis=0)

    def model_mean(self, t, like=None):
        """``t`` averaged over the model group (zeros of ``like`` for None)."""
        import torch
        import torch.distributed as dist

        g = torch.zeros_like(like) if t is None else t.detach().clone()
        dist.all_reduce(g, group=self.group)
        return g / self.M

    def param_grads(self, named):
        """Each gradient summed over the data ranks and averaged over the
        model ranks (what DDP's world mean gives, times the data size)."""
        import torch
        import torch.distributed as dist

        out = {}
        for n, p in named:
            g = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
            dist.all_reduce(g)
            out[n] = _np(g / self.M)
        return out


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def task_executors(payload: dict) -> dict:
    import torch

    from deco_tpu_torch.models.dit_c2i_deco import DeCoC2I
    from deco_tpu_torch.models.dit_t2i import DeCoT2I
    from deco_tpu_torch.models.moe import MoEMLP, dispatch_tensors
    from deco_tpu_torch.parallel import mesh as mesh_lib
    from deco_tpu_torch.parallel.ep_moe import expert_parallel_moe
    from deco_tpu_torch.parallel.pipeline import dit_block_apply, pipeline_apply
    from deco_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_local
    from deco_tpu_torch.parallel.sp_trunk import (
        sequence_parallel_joint_trunk,
        sequence_parallel_trunk,
    )
    from deco_tpu_torch.parallel.tp_trunk import tensor_parallel_joint_trunk, tensor_parallel_trunk

    T = {k: torch.from_numpy(v) if hasattr(v, "dtype") else v for k, v in payload.items()}

    def c2i(**kw):
        m = DeCoC2I(**payload["c2i_kw"], dtype=torch.float32, device="cpu", **kw)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in payload["c2i_sd"].items()})
        return m

    def t2i(**kw):
        m = DeCoT2I(**payload["t2i_kw"], dtype=torch.float32, device="cpu", **kw)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in payload["t2i_sd"].items()})
        return m

    results = {}
    for shape in payload["meshes"]:
        ctx = _Ctx(mesh_lib.make_mesh(data=shape[0], model=shape[1]))
        res = results[tuple(shape)] = {}

        # ring attention, local chunks, with and without the text keys
        for extra in (False, True):
            q, k, v = (ctx.chunk(ctx.rows(T[n])).clone().requires_grad_() for n in "qkv")
            ekv = None
            if extra:
                ekv = tuple(ctx.rows(T[n]).clone().requires_grad_() for n in ("ek", "ev"))
            out = ring_attention_local(q, k, v, group=ctx.group, extra_kv=ekv)
            (out * ctx.chunk(ctx.rows(T["ring_cot"]))).sum().backward()
            r = {n: ctx.stitch(t, seq_dim=1) for n, t in
                 (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}
            if extra:
                r.update(dek=ctx.stitch(ekv[0].grad), dev=ctx.stitch(ekv[1].grad))
            res[f"ring_extra{int(extra)}"] = r
        with torch.no_grad():
            whole = ring_attention(ctx.rows(T["q"]), ctx.rows(T["k"]), ctx.rows(T["v"]),
                                   mesh=ctx.mesh)
        res["ring_standalone"] = ctx.stitch(whole)

        # the executors on the models' trunks
        model, tmodel = c2i(), t2i()
        rope = model._rope(*payload["c2i_grid"], torch.device("cpu"))
        trope = tmodel._rope(*payload["t2i_grid"], tmodel.patch_scaling_hw, torch.device("cpu"))
        for name, fn, blocks, args, cot in (
                ("sp", sequence_parallel_trunk, model.blocks, ("xs", "cs"), "cot_s"),
                ("tp", tensor_parallel_trunk, model.blocks, ("xs", "cs"), "cot_s"),
                ("sp_joint", sequence_parallel_joint_trunk, tmodel.blocks, ("xj", "yj", "cj"),
                 "cot_j"),
                ("tp_joint", tensor_parallel_joint_trunk, tmodel.blocks, ("xj", "yj", "cj"),
                 "cot_j")):
            for remat in (False, True):
                blocks.zero_grad(set_to_none=True)
                inputs = [ctx.rows(T[a]).clone().requires_grad_() for a in args]
                out = fn(blocks, *inputs, trope if "joint" in name else rope, mesh=ctx.mesh,
                         remat=remat)
                (out * ctx.rows(T[cot])).sum().backward()
                res[f"{name}_remat{int(remat)}"] = dict(
                    out=ctx.stitch(out),
                    inputs=[ctx.stitch(ctx.model_mean(a.grad)) for a in inputs],
                    params=ctx.param_grads(blocks.named_parameters()))

        # the models with trunk_parallel
        for kind, build, img, cond, cot in (("c2i", c2i, "x", "y", "cot_img"),
                                            ("t2i", t2i, "x2", "y2", "cot2")):
            for mode in ("sp", "tp"):
                m = build(trunk_parallel=mode)
                with mesh_lib.use_mesh(ctx.mesh):
                    out = m(ctx.rows(T[img]), ctx.rows(T["t" if kind == "c2i" else "t2"]),
                            ctx.rows(T[cond]))
                (out * ctx.rows(T[cot])).sum().backward()
                res[f"{kind}_{mode}"] = dict(out=ctx.stitch(out),
                                             params=ctx.param_grads(m.named_parameters()))

        # the pipeline at M = 2 and 4 (M must divide the rank's rows)
        xs = ctx.rows(T["xs"])
        for mb in (2, 4):
            if xs.shape[0] % mb:
                continue
            model.zero_grad(set_to_none=True)
            x = xs.clone().requires_grad_()
            with mesh_lib.use_mesh(ctx.mesh):
                out = pipeline_apply(dit_block_apply, model.blocks, x, (ctx.rows(T["cs"]),),
                                     (rope,), num_microbatches=mb)
            (out * ctx.rows(T["cot_s"])).sum().backward()
            res[f"pipeline_m{mb}"] = dict(out=ctx.stitch(out),
                                          x=ctx.stitch(ctx.model_mean(x.grad, x)),
                                          params=ctx.param_grads(model.blocks.named_parameters()))

        # MoE: the dense module and expert parallelism, routing compared exactly
        for cf in payload["moe_capacity_factors"]:
            moe = MoEMLP(*payload["moe_dims"], top_k=2, capacity_factor=cf, dtype=torch.float32)
            moe.load_state_dict({k: torch.from_numpy(v) for k, v in payload["moe_sd"].items()})
            xm = T["xm"]
            dense = moe(xm)
            cap = payload["moe_capacity"][str(cf)]
            probs = torch.softmax(xm.float() @ moe.router, dim=-1)
            dense_routing = [dispatch_tensors(p, 2, cap)[:2] for p in probs]
            x_loc = ctx.chunk(xm)
            y, aux, routing = expert_parallel_moe(moe.params(), x_loc, capacity=cap,
                                                  mesh=ctx.mesh, dtype=torch.float32,
                                                  return_routing=True)
            same = all(torch.equal(ctx.chunk(dd, 0), ed) and torch.equal(ctx.chunk(dc, 0), ec)
                       for (dd, dc), (ed, ec) in zip(dense_routing, routing))
            res[f"moe_{cf}"] = dict(
                dense=_np(dense), aux_dense=float(moe.aux_loss), aux_ep=float(aux),
                ep=ctx.stitch(y, seq_dim=1) if ctx.D == 1 else None, routing_equal=same,
                dispatch=[_np(d) for d, _ in dense_routing],
                combine=[_np(c) for _, c in dense_routing],
                drops=[int(2 * probs.shape[1] - d.sum()) for d, _ in dense_routing])

        # the refusals: axes that do not divide what they shard
        if ctx.M == 4:
            odd = c2i()
            res["refusals"] = dict(
                tokens=_raises(lambda: sequence_parallel_trunk(
                    odd.blocks, T["xs"][:, :6], T["cs"], tuple(r[:6] for r in rope),
                    mesh=ctx.mesh)),
                heads=_raises(lambda: tensor_parallel_trunk(
                    DeCoC2I(**{**payload["c2i_kw"], "num_groups": 2}, dtype=torch.float32,
                            device="cpu").blocks, T["xs"][:, :, :48], T["cs"],
                    DeCoC2I(**{**payload["c2i_kw"], "num_groups": 2}, device="cpu")._rope(
                        *payload["c2i_grid"], torch.device("cpu")), mesh=ctx.mesh)),
                layers=_raises(lambda: pipeline_apply(
                    dit_block_apply, odd.blocks[:2], T["xs"], (T["cs"],), (rope,),
                    mesh=ctx.mesh, num_microbatches=2)),
                microbatches=_raises(lambda: pipeline_apply(
                    dit_block_apply, odd.blocks, T["xs"][:3], (T["cs"][:3],), (rope,),
                    mesh=ctx.mesh, num_microbatches=2)),
                experts=_raises(lambda: expert_parallel_moe(
                    {k: v[..., :2] if k == "router" else v[:2] for k, v in
                     MoEMLP(*payload["moe_dims"]).params().items()}, ctx.chunk(T["xm"]),
                    capacity=4, mesh=ctx.mesh)),
                mesh=_raises(lambda: mesh_lib.make_mesh(model=3)))
    return results


def task_cli(payload: dict) -> dict:
    """``payload["runs"]``: argument lists for ``deco_tpu_torch.cli.main``,
    run in order on every rank (TensorBoard left out: its import is slow
    and not what the tests check)."""
    from deco_tpu_torch import cli
    from deco_tpu_torch.train import hooks

    hooks._tensorboard = lambda logdir: None
    probes = _probe_fsdp_units() if payload.get("probe_fsdp_units") else None
    steps = []
    for argv in payload["runs"]:
        out = cli.main(argv)
        steps.append(getattr(out, "step", None))
    return {"steps": steps, "fsdp_units": probes}


def _probe_fsdp_units() -> list:
    """Records, as each trunk block's first forward starts (after FSDP2's
    gather), which trunk and decoder blocks are FSDP2 units of their own and
    which trunk blocks' ``qkv`` weights are DTensor shards at that moment."""
    from torch.distributed.fsdp import FSDPModule

    from deco_tpu_torch.parallel import mesh as mesh_lib

    probes: list = []
    shard_params = mesh_lib.shard_params

    def probed(module, mesh, **kw):
        out = shard_params(module, mesh, **kw)
        blocks = list(module.blocks)

        def pre_hook(i):
            def hook(mod, args):
                if len(probes) < len(blocks):
                    probes.append(dict(
                        block=i, units=[isinstance(b, FSDPModule) for b in blocks],
                        decoder_units=[isinstance(b, FSDPModule)
                                       for b in module.dec_net.res_blocks],
                        sharded=[mesh_lib.is_dtensor(b.attn.qkv.weight) for b in blocks]))
            return hook

        for i, b in enumerate(blocks):
            b.register_forward_pre_hook(pre_hook(i))
        return out

    mesh_lib.shard_params = probed
    return probes


TASKS = {"executors": task_executors, "cli": task_cli}


def main(task: str, folder: str) -> None:
    import torch

    from deco_tpu_torch.parallel import distributed

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    with open(os.path.join(folder, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    distributed.initialize(device="cpu")
    result = TASKS[task](payload)
    with open(os.path.join(folder, f"rank{distributed.rank()}.pkl"), "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1], sys.argv[2])
