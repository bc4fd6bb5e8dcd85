"""Rank processes of the port's data-parallel tests (`test_torch_dp_*.py`).

The tests spawn W ranks with `torch.multiprocessing` over gloo on the CPU,
each joining its group through a `file://` init method in the test's own
`tmp_path`, so that concurrent test workers never share a port. `spawn`
kills ranks that outlive its deadline, and every group's collectives give
up after `GROUP_TIMEOUT`, well before it. This module imports no JAX: the
parent computes the JAX references and hands the ranks numpy inputs
through files; each rank writes what it computed to `out/rank{r}.pt` for
the parent to read.
"""
import datetime
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


# how long a spawned group may run before its ranks are killed, and how
# long a collective of a rank's group waits for a missing rank (well under
# the deadline, so that a hang fails the collective first, with its error)
DEADLINE_S = 120.0
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def spawn(fn, world: int, tmp_path, *args, deadline: float = DEADLINE_S
          ) -> list:
    """Run `fn(rank, world, tmp_path, *args)` in `world` processes; returns
    what each rank saved with `save_result`, rank order. A rank that fails
    fails the call (the others are stopped); ranks still running after
    `deadline` seconds are killed and the call fails, so that a hang costs
    one test its deadline, not the suite its limit."""
    out = os.path.join(str(tmp_path), "out")
    os.makedirs(out, exist_ok=True)
    ctx = mp.spawn(_entry, args=(fn, world, str(tmp_path), args),
                   nprocs=world, join=False)
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(0.0, min(1.0, end - time.monotonic()))):
            if time.monotonic() >= end:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {deadline:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, fn, world, tmp_path, args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    fn(rank, world, tmp_path, *args)


def save_result(tmp_path: str, rank: int, result) -> None:
    torch.save(result, os.path.join(tmp_path, "out", f"rank{rank}.pt"))


def init_url(tmp_path: str, tag: str) -> str:
    """A fresh `file://` init method for one process group."""
    return "file://" + os.path.join(tmp_path, f"init-{tag}")


# ----------------------------------------------------------------------
# losses


def loss_rank(rank, world, tmp_path, cases):
    """Each case (name, kind, flags) on this rank's rows of the global
    features in `inputs.npz`: the loss and the gradients of the rank's
    features and of logit_scale (and logit_bias) after every rank's
    backward."""
    from megatron_clip_tpu_torch import losses
    dist.init_process_group("gloo", init_method=init_url(tmp_path, "loss"),
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    data = np.load(os.path.join(tmp_path, "inputs.npz"))
    n = data["img"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    group = dist.group.WORLD
    result = {}
    for name, kind, flags in cases:
        img = torch.tensor(data["img"][rows], requires_grad=True)
        txt = torch.tensor(data["txt"][rows], requires_grad=True)
        scale = torch.tensor(data["scale"], requires_grad=True)
        bias = torch.tensor(data["bias"], requires_grad=True)
        if kind == "gather":
            gi, gt = losses.gather_features(img, txt, group, **flags)
            loss = (gi * torch.tensor(data["w_img"])).sum() \
                + (gt * torch.tensor(data["w_txt"])).sum()
            gathered = (gi.detach().numpy(), gt.detach().numpy())
        elif kind == "clip":
            loss = losses.ClipLoss(group=group, **flags)(img, txt, scale)
            gathered = None
        else:
            loss = losses.SigLipLoss(group=group)(img, txt, scale, bias)
            gathered = None
        loss.backward()
        result[name] = {
            "loss": float(loss.detach()), "gathered": gathered,
            **{k: None if t.grad is None else t.grad.numpy()
               for k, t in (("img", img), ("txt", txt), ("scale", scale),
                            ("bias", bias))}}
    dist.destroy_process_group()
    save_result(tmp_path, rank, result)


# ----------------------------------------------------------------------
# the trainer


def _patch_trainer(start, patch_ids, record):
    """The trainer's model built from `start` (a state dict of numpy
    arrays), its patch indices from `patch_ids` ({(step, block): ids of
    the block's global rows}), and each step's metrics appended to
    `record`."""
    from megatron_clip_tpu_torch.training import loop, train_step
    create = loop.factory.create_model

    def created(*args, **kw):
        model = create(*args, **kw)
        if start is not None:
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in start.items()})
        return model
    loop.factory.create_model = created
    if patch_ids is not None:
        def ids(seed, step, microbatch, rows, patches, rate):
            got = patch_ids[(step, microbatch)]
            assert got.shape[0] == rows, (got.shape, rows)
            return torch.from_numpy(got)
        train_step.patch_keep_ids = ids
    step = loop._JointRunner.step

    def recorded(self, images, texts):
        m = step(self, images, texts)
        record.append({k: float(v) for k, v in m.items()})
        return m
    loop._JointRunner.step = recorded
    built = []
    init = loop._JointRunner.__init__

    def keep(self, *args, **kw):
        init(self, *args, **kw)
        built.append(self)
    loop._JointRunner.__init__ = keep
    return built


def _params(runner) -> dict:
    return {n: p.detach().clone() for n, p in
            runner.model.named_parameters()}


def _state_bytes(runner) -> dict:
    """The bytes of the rank's parameters (a sharded model's shards) and
    of its optimizer's moments."""
    opt = runner.state.opt_state
    return {"params": sum(p.numel() * p.element_size()
                          for p in runner.model.parameters()),
            "moments": sum(t.numel() * t.element_size()
                           for t in (*opt.mu.values(), *opt.nu.values()))}


def trainer_rank(rank, world, tmp_path, jobs):
    """`run_training(argv)` on this rank of the CPU group for each job
    (argv, start, patch_ids) of `jobs`, a group each: each step's metrics,
    the final parameters, the final metrics."""
    from megatron_clip_tpu_torch.training import loop, train_step
    from megatron_clip_tpu_torch.training.params import parse_args
    record, out = [], []
    saved = (loop.factory.create_model, train_step.patch_keep_ids,
             loop._JointRunner.step, loop._JointRunner.__init__)
    for i, (argv, start, patch_ids) in enumerate(jobs):
        record.clear()
        built = _patch_trainer(start, patch_ids, record)
        final = loop.run_training(parse_args(
            argv + ["--dist-url", init_url(tmp_path, f"train{i}")]),
            device="cpu", timeout=GROUP_TIMEOUT)
        out.append({"steps": list(record), "final": final,
                    "params": _params(built[-1]),
                    "state_bytes": _state_bytes(built[-1])})
        (loop.factory.create_model, train_step.patch_keep_ids,
         loop._JointRunner.step, loop._JointRunner.__init__) = saved
    save_result(tmp_path, rank, out)


def resume_rank(rank, world, tmp_path, argv, term_rank, term_after):
    """The run of `argv` whole; then cut by SIGTERM on rank `term_rank`
    after its step `term_after`, with --save; then resumed with --resume
    latest. Each run's step metrics and final parameters, and the step
    every rank stopped at."""
    import megatron_clip_tpu_torch.training.loop as loop
    from megatron_clip_tpu_torch.training.params import parse_args
    record = []
    built = _patch_trainer(None, None, record)
    save = os.path.join(tmp_path, "ck")

    def run(tag, extra):
        record.clear()
        final = loop.run_training(parse_args(
            argv + extra + ["--dist-url", init_url(tmp_path, tag)]),
            device="cpu", timeout=GROUP_TIMEOUT)
        return {"steps": list(record), "final": final,
                "params": _params(built[-1])}
    whole = run("whole", [])
    step = loop._JointRunner.step

    def step_then_term(self, images, texts):
        m = step(self, images, texts)
        if rank == term_rank and len(record) == term_after:
            os.kill(os.getpid(), signal.SIGTERM)
        return m
    loop._JointRunner.step = step_then_term
    cut = run("cut", ["--save", save, "--name", "t"])
    loop._JointRunner.step = step
    resumed = run("resumed", ["--save", save, "--name", "t", "--resume",
                              "latest"])
    save_result(tmp_path, rank, {"whole": whole, "cut": cut,
                                 "resumed": resumed})


def refusal_rank(rank, world, tmp_path, argvs):
    """`run_training(argv)` on this rank for each of `argvs`; the exception
    each raised, as (type name, message), or None."""
    from megatron_clip_tpu_torch.parallel import mesh
    from megatron_clip_tpu_torch.training.loop import run_training
    from megatron_clip_tpu_torch.training.params import parse_args
    got = []
    for i, argv in enumerate(argvs):
        try:
            run_training(parse_args(argv + [
                "--dist-url", init_url(tmp_path, f"refuse{i}")]),
                device="cpu", timeout=GROUP_TIMEOUT)
            got.append(None)
        except Exception as e:  # noqa: BLE001 — handed to the parent
            got.append((type(e).__name__, str(e)))
        got[-1] = (got[-1], mesh.group() is None)
    save_result(tmp_path, rank, got)



# ----------------------------------------------------------------------
# the GPT trainer


def gpt_rank(rank, world, tmp_path, jobs):
    """`pretrain_gpt.run(argv)` on this rank of the CPU group for each job
    (tag, argv, start, term_after) of `jobs`, a group each: the model built
    from `start` (a state dict of numpy arrays) on rank 0 only (the others
    keep their own draw, so that rank 0's broadcast is what they train
    from), and with `term_after` a SIGTERM sent to rank 1 after its step
    `term_after`. Each job's result (its `run` output with the final
    parameters, a sharded model's this rank's shards; the bytes of the
    rank's parameters and optimizer moments, `state_bytes`; each step's
    grad norm, `grad_norms`; the gradients the run's first step gave the
    optimizer, a sharded model's this rank's shards, `grads1`; the bytes
    of the tensors a save's state tree left on this rank, `save_bytes`),
    or
    the exception it raised as (type name, message), and whether the
    group was left."""
    from megatron_clip_tpu_torch import pretrain_gpt
    from megatron_clip_tpu_torch.training import workload
    create, run_wl, step = (pretrain_gpt.create_gpt,
                            pretrain_gpt.run_workload, workload._Runner.step)
    reduced, tree = (workload._Runner._reduced_grads,
                     workload._Runner.state_tree)
    out = []
    for tag, argv, start, term_after in jobs:
        cap = {}

        def created(cfg, **kw):
            model = create(cfg, **kw)
            if start is not None and rank == 0:
                model.load_state_dict({k: torch.from_numpy(v)
                                       for k, v in start.items()})
            return model

        def ran(model, *a, **kw):
            res = run_wl(model, *a, **kw)
            cap["params"] = {n: p.detach().clone()
                             for n, p in model.named_parameters()}
            return res

        def stepped(self, batch, i):
            opt = self.opt_state
            cap["state_bytes"] = {
                "params": sum(p.numel() * p.element_size()
                              for p in self.params.values()),
                "moments": sum(t.numel() * t.element_size()
                               for t in (*opt.mu.values(),
                                         *opt.nu.values()))}
            m = step(self, batch, i)
            cap.setdefault("grad_norms", []).append(float(m["grad_norm"]))
            if rank == 1 and i == term_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return m

        def reduced_grads(self, *a):
            loss, grads = reduced(self, *a)
            if "grads1" not in cap:
                cap["grads1"] = {n: g.detach().clone()
                                 for n, g in grads.items()}
            return loss, grads
        def state_tree(self, *a):
            t = tree(self, *a)
            cap["save_bytes"] = sum(
                x.numel() * x.element_size()
                for x in torch.utils._pytree.tree_leaves(t)
                if torch.is_tensor(x))
            return t
        pretrain_gpt.create_gpt, pretrain_gpt.run_workload = created, ran
        workload._Runner.step = stepped
        workload._Runner._reduced_grads = reduced_grads
        workload._Runner.state_tree = state_tree
        args = pretrain_gpt.parse_args(argv + ["--device", "cpu"])
        args.dist_url = init_url(tmp_path, f"gpt-{tag}")
        try:
            res = pretrain_gpt.run(args, timeout=GROUP_TIMEOUT)
            res["params"] = cap["params"]
            res["state_bytes"] = cap.get("state_bytes")
            res["grad_norms"] = cap.get("grad_norms", [])
            res["grads1"] = cap.get("grads1")
            res["save_bytes"] = cap.get("save_bytes")
        except (Exception, SystemExit) as e:  # noqa: BLE001 — to the parent
            res = {"error": (type(e).__name__, str(e))}
        finally:
            pretrain_gpt.create_gpt, pretrain_gpt.run_workload = create, run_wl
            workload._Runner.step = step
            workload._Runner._reduced_grads = reduced
            workload._Runner.state_tree = tree
        res["left"] = pretrain_gpt.mesh.group() is None
        out.append(res)
    save_result(tmp_path, rank, out)


# ----------------------------------------------------------------------
# the text-generation server


def put(url: str, request: dict, timeout: float = 60.0):
    """PUT `request` to the server's /api: (status, the JSON answer)."""
    import json
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url + "/api", method="PUT",
                                 data=json.dumps(request).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_rank(rank, world, tmp_path, cases):
    """Each case (name, argv, requests): the server tool's `build` on this
    rank of a --tensor-model-parallel-size launch (its group through a
    `file://` store), rank 0 serving on port 0 and putting each request to
    itself over HTTP while the others follow, then releasing them. Rank 0
    saves, by case, the answers, its tensor-parallel size and its wqkv
    shard's shape."""
    from megatron_clip_tpu_torch.inference.server import run_server
    from megatron_clip_tpu_torch.parallel import mesh
    from megatron_clip_tpu_torch.tools import run_text_generation_server \
        as tool
    parse, out = tool.parse_args, {}
    for name, argv, requests in cases:
        def with_store(a, name=name):
            args = parse(a)
            args.dist_url = init_url(tmp_path, f"serve-{name}")
            return args
        tool.parse_args = with_store
        try:
            service, _ = tool.build(argv, timeout=GROUP_TIMEOUT)
        finally:
            tool.parse_args = parse
        try:
            if not service.leader:
                service.follow()
                continue
            srv = run_server(service, port=0)
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            try:
                out[name] = {
                    "answers": [put(url, r) for r in requests],
                    "tp": service.model.tp,
                    "wqkv": tuple(service.model.blocks[0].attn["wqkv"].shape)}
            finally:
                srv.shutdown()
                service.stop()
        finally:
            mesh.destroy()
    save_result(tmp_path, rank, out)
