"""Training launcher: the train loop with sharding rules checked against the
mesh, a background data pipeline, async checkpointing, restart-from-latest,
heartbeats and straggler tracking (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128

Runs on the card (``--device cpu`` for the CPU), on the one-device host
mesh.  On a mesh of several devices (``launch.mesh.make_mesh(shape, axes,
devices=...)``, every rank of an initialised process group calling
``train`` with it) the state is placed by the sharding rules as DTensors
and each step's batch by ``batch_sharding``; every rank builds the same
global batch (the pipeline is a pure function of the step), checkpoints
gather the state and rank 0 writes them and logs.  ``--mesh
single|multi`` (16x16 / 2x16x16) are descriptions this host cannot run:
they raise, naming the world size they need.  The attention path is the
config's ``attn_impl`` (callers set ``"flash"``, kernel K5, with
``dataclasses.replace``).  Restart semantics: if ``--checkpoint-dir`` holds
a checkpoint, training resumes from the latest step (the data pipeline is
a pure function of the step, so the token stream realigns exactly).  A
checkpoint ``step_<n>`` holds the state after ``n`` steps, so a resumed run
takes step ``n`` next.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch import runtime
from repro_torch.checkpoint.checkpoint import (CheckpointManager,
                                               latest_step,
                                               restore_checkpoint)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import Mesh, host_mesh, make_production_mesh
from repro_torch.models import build
from repro_torch.parallel import ctx
from repro_torch.parallel.sharding import (batch_sharding, check_realisable,
                                           embeds_sharding, full, place,
                                           state_shardings)
from repro_torch.train import ft
from repro_torch.train.loop import init_state, make_train_step


def _batch_specs(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    b = batch["tokens"].shape[0]
    return {k: embeds_sharding(mesh, b) if k == "embeds" else
            batch_sharding(mesh, b, ndim=v.ndim) for k, v in batch.items()}


def train(cfg: ArchConfig, shape: ShapeConfig, run: RunConfig,
          mesh: Mesh = None, worker: str = None,
          log=print) -> Dict[str, Any]:
    """Train ``run.total_steps`` steps of ``shape``'s batches from the
    latest checkpoint under ``run.checkpoint_dir`` (else from
    ``model.init(run.seed)``), saving every ``run.checkpoint_every`` steps
    and at the end.  Returns the first and final loss, the per-step losses
    and host-clock seconds (each step synchronised), the seconds each save
    held the loop, the step it started from and the fault-tolerance
    health check.  On a mesh of several devices every rank calls it (its
    ``worker`` defaults to ``w<rank>``); rank 0 logs."""
    mesh = mesh or host_mesh()
    placed = not mesh.trivial
    if placed:
        mesh.device_mesh()          # raises without the ranks it needs
    dev = mesh.local_device
    rank = dist.get_rank() if placed else 0
    worker = worker or f"w{rank}"
    if rank:                        # rank 0 logs
        log = lambda _msg: None
    model = build(cfg)
    # shapes without storage: the rules' input and the restore template
    template = init_state(model, run.seed, device="meta")
    specs = state_shardings(template, mesh)
    check_realisable(specs, template, mesh)
    step_fn = make_train_step(model, run)

    manager = CheckpointManager(run.checkpoint_dir, keep=3)
    monitor = ft.FaultToleranceManager(
        heartbeat=ft.HeartbeatMonitor(
            os.path.join(run.checkpoint_dir, "hb")),
        stragglers=ft.StragglerDetector(),
        checkpoint_dir=run.checkpoint_dir, workers=(worker,))

    start = 0
    with ctx.mesh_context(mesh):
        if latest_step(run.checkpoint_dir) is not None:
            start, state = restore_checkpoint(
                run.checkpoint_dir, template, device=dev,
                shardings=specs if placed else None, mesh=mesh)
            log(f"restored checkpoint at step {start}")
        else:
            state = init_state(model, run.seed, device=dev)
            if placed:
                state = place(state, specs, mesh)
        del template

        pipe = DataPipeline(cfg, shape, seed=run.seed, start_step=start)
        losses, step_s, save_s = [], [], []
        try:
            for step, batch in pipe:
                if step >= run.total_steps:
                    break
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in batch.items()}
                if placed:
                    batch = place(batch, _batch_specs(batch, mesh), mesh)
                runtime.synchronize(dev)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                metrics = full(metrics)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                monitor.on_step(worker, dt)
                losses.append(loss)
                step_s.append(dt)
                if step % run.log_every == 0:
                    log(f"step {step:5d} loss {loss:8.4f} "
                        f"grad_norm {float(metrics['grad_norm']):7.3f} "
                        f"({dt:5.2f}s/step)")
                done = step + 1
                if run.checkpoint_every and \
                        done % run.checkpoint_every == 0 and \
                        done < run.total_steps:
                    t0 = time.perf_counter()
                    manager.save(done, state, extra={"loss": loss})
                    save_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            manager.save(start + len(losses), state,
                         extra={"loss": losses[-1] if losses else None})
            manager.wait()
            if placed:              # every rank sees the final checkpoint
                dist.barrier()
            save_s.append(time.perf_counter() - t0)
        finally:
            pipe.close()
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "steps": len(losses), "start_step": start, "losses": losses,
            "step_s": step_s, "save_s": save_s,
            "health": monitor.health_check()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--mesh", choices=("host", "single", "multi"),
                    default="host")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    run = RunConfig(learning_rate=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 10, 1),
                    microbatch=args.microbatch,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every,
                    log_every=max(args.steps // 50, 1))
    mesh = host_mesh(args.device) if args.mesh == "host" else \
        make_production_mesh(multi_pod=(args.mesh == "multi"))
    out = train(cfg, shape, run, mesh=mesh)
    print(f"done: {out}")


if __name__ == "__main__":
    main()
