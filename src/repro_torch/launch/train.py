"""Training loop and CLI, on the card by default (the reference's
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --steps 6 --batch 4 --seq 4096

A real (allocated, stepped) training loop: the deterministic data pipeline,
remat per block, AdamW, atomic checkpoints with restart, the step watchdog
and optional gradient compression.  Kill the process at any step and rerun the same command with
the same ``--ckpt-dir``: it resumes from the last complete checkpoint with
the same batches (the pipeline is a pure function of the step counter).

Flags are the reference CLI's, plus ``--device`` (default: the card; ``cpu``
runs float32 through the plain PyTorch versions, as the reference does on a
CPU backend), ``--profile`` (the last step under ``torch.profiler``),
``--log-every`` (the reference logs every 10th step and the last; a restart
test compares every step's loss, so it asks for 1) and
``--kill-after-steps`` (SIGKILL after that many steps of this process, for
restart tests).  Gradient compression is ``train_loop``'s ``compression=``,
and a mesh its ``mesh=``, as in the reference, whose CLI has a flag for
neither.

``train_loop(mesh=)`` trains on an
:class:`~repro_torch.distributed.sharding.LMMesh` (``launch.mesh.make_local_mesh``,
``distributed.elastic.elastic_remesh``): the state is laid out by
``state_pspecs`` (FSDP over ``data``, tensor and expert parallelism over
``model``), each step's batch split by ``batch_pspec``.  A checkpoint holds
the gathered state in the same format as without a mesh, so it restores
onto any mesh (``reshard_state``), or none.

Each logged step prints its loss (the exact float), grad norm, learning
rate, the step's time on the host clock between device fences, tokens/s,
the peak device memory of the step and a crc32 of the batch's tokens.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import signal
import time
import zlib

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig, get_config, get_reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device, synchronize
from repro_torch.distributed.elastic import StepWatchdog, reshard_state
from repro_torch.distributed.sharding import (
    Sharded,
    _lm_map,
    batch_pspec,
    gather,
    place,
    state_pspecs,
)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.profiling import print_profile
from repro_torch.train.trainer import _requires_grad, make_train_step, train_state_init

__all__ = ["train_loop", "main"]


def train_loop(
    cfg,
    shape: ShapeConfig,
    *,
    steps: int = 100,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    seed: int = 0,
    opt: AdamWConfig | None = None,
    compression=None,
    log_every: int = 10,
    watchdog_timeout: float = 3600.0,
    device=None,
    kill_after_steps: int | None = None,
    step_context=None,
    profile: bool = False,
    mesh=None,
):
    """Train; returns (final state, list of metric dicts of the logged
    steps).

    compression: optional stateless grads -> grads callable (e.g. built
    from :mod:`repro_torch.distributed.compression`), applied to the
    gradient tree before the optimizer (``make_train_step``'s
    ``grad_transform``).

    step_context: optional ``i -> context manager`` entered around step
    ``i`` (0-based) inside its device fences, e.g. to count kernel
    launches per step.  profile: the last step runs under
    ``torch.profiler`` and its phases are printed; it is logged and
    checkpointed as any other, so the state returned is the state saved,
    and its logged time includes the profiler's overhead.

    log_every: the reference's interval; the CLI's ``--log-every 1`` prints
    every step, which a kill/resume comparison of steps 4-6 needs.

    mesh: an ``LMMesh`` to train on (``device`` is then its first device):
    the state is the unsharded one from the same seed, placed by
    ``state_pspecs``; checkpoints are saved gathered, in the format and
    with the paths of an unsharded state, and a restore is resharded onto
    ``mesh``.  Each logged step's peak memory is the first device's."""
    device = resolve_device(mesh.flat[0] if mesh is not None else device)
    devices = mesh.flat if mesh is not None else device
    opt = opt or AdamWConfig(total_steps=steps, warmup_steps=max(steps // 20, 1))

    def init():
        gen = torch.Generator(device=device).manual_seed(seed)
        if mesh is None:
            return train_state_init(gen, cfg)
        return train_state_init(gen, cfg, mesh=mesh)

    state = init()

    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr is not None and mgr.available_steps():
        if mesh is not None:
            # a sharded state restores through host tensors of its full shapes
            state = _host_like(state)
        restored = mgr.restore_latest(state)
        if restored is not None:
            state, _, start_step = restored
            if mesh is not None:
                state = reshard_state(state, state_pspecs(state, mesh), mesh)
            _requires_grad(state.params)
            print(f"[train] resumed from checkpoint step {start_step}", flush=True)
        elif mesh is not None:
            state = init()

    def saved(state):
        return gather(state, "cpu") if mesh is not None else state

    step_fn = make_train_step(cfg, opt, grad_transform=compression, mesh=mesh)
    pipe = TokenPipeline(cfg, shape, seed=seed, start_step=start_step)
    wd = StepWatchdog(watchdog_timeout)
    tokens = shape.global_batch * shape.seq_len
    history = []
    metrics, step_s = None, 0.0

    def one_step(batch):
        nonlocal state, metrics, step_s
        ts = time.perf_counter()
        with torch.profiler.record_function("train.step"):
            state, metrics = step_fn(state, batch)
            synchronize(devices)
        step_s = time.perf_counter() - ts

    t0 = time.perf_counter()
    try:
        for i in range(start_step, steps):
            host = next(pipe)
            if mesh is not None:
                batch = place(host, batch_pspec(mesh.axis_names, host), mesh)
            else:
                batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            synchronize(devices)
            ctx = step_context(i) if step_context is not None else contextlib.nullcontext()
            with wd.step(), ctx:
                if profile and i + 1 == steps:
                    print_profile(lambda: one_step(batch), prefix="train.")
                else:
                    one_step(batch)
            if (i + 1) % log_every == 0 or i + 1 == steps:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=i + 1, wall_s=time.perf_counter() - t0, step_s=step_s,
                         tokens_per_s=tokens / step_s,
                         peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                                   if device.type == "cuda" else None),
                         tokens_crc32=zlib.crc32(host["tokens"].tobytes()))
                history.append(m)
                peak = f" peak {m['peak_gib']:.3f} GiB" if m["peak_gib"] is not None else ""
                print(f"[train] step {i + 1:5d} loss {m['loss']!r} gnorm {m['grad_norm']:.3f} "
                      f"lr {m['lr']:.2e} step {step_s:.4f}s {m['tokens_per_s']:.0f} tok/s{peak} "
                      f"tokens crc32 {m['tokens_crc32']:08x} ({m['wall_s']:.1f}s)", flush=True)
            if mgr is not None and (i + 1) % ckpt_every == 0:
                mgr.save(i + 1, saved(state), extra={"arch": cfg.name})
            if kill_after_steps is not None and i + 1 - start_step >= kill_after_steps:
                print(f"[train] kill-after-steps: SIGKILL after step {i + 1}", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
    finally:
        pipe.close()
    if mgr is not None:
        mgr.save(steps, saved(state), extra={"arch": cfg.name})
    return state, history


def _host_like(state):
    """A tree like ``state`` of empty host tensors of its leaves' full
    shapes and dtypes: what a checkpoint restores into before a reshard."""
    return _lm_map(lambda _, x: torch.empty(x.shape, dtype=x.dtype)
                   if isinstance(x, (Sharded, torch.Tensor)) else x, state)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the small same-family smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs float32 through the "
                         "plain PyTorch versions)")
    ap.add_argument("--profile", action="store_true",
                    help="run the last step under torch.profiler: host and device time "
                         "of its phases per kernel")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print every n-th step and the last (default: the reference's 10; "
                         "restart tests compare every step's loss with 1)")
    ap.add_argument("--kill-after-steps", type=int, default=None,
                    help="SIGKILL this process after that many of its steps (restart tests)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1))
    train_loop(
        cfg, shape, steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, seed=args.seed, opt=opt, log_every=args.log_every,
        device=device, kill_after_steps=args.kill_after_steps, profile=args.profile,
    )


if __name__ == "__main__":
    main()
