"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke] [--device cpu] [...]`` (port of ``repro.launch.train``).

The production loop at a runnable scale: config -> init (seed 0) -> train
loop with a checkpoint every K steps, restart from the latest checkpoint
with the data cursor, a straggler watchdog, and the deterministic data
pipeline, driven by ``dist.fault.run_with_restarts``. It runs on the CUDA
card unless ``--device`` names another device. ``--arch`` takes every id;
the decoder-only archs (dense, MoE, SSM, hybrid) train, whisper-base and
phi-3-vision-4.2b raise naming their items (13.4, 13.5). One device:
JAX's mesh and sharded init wait with the rest of ``launch/`` (ROADMAP
Queue 1 item 13.6).
"""

from __future__ import annotations

import argparse
import time

from ..ckpt import checkpoint as C
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core._device import resolve_device
from ..data.pipeline import DataConfig, batch_at
from ..dist.fault import FaultConfig, StragglerWatchdog, run_with_restarts
from ..models import model as M
from ..optim.adam import AdamConfig, init_opt_state
from ..train.trainer import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    opt_cfg = AdamConfig(lr=args.lr, total_steps=args.steps,
                         warmup_steps=max(1, args.steps // 20),
                         moment_dtype=cfg.moment_dtype)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    fault_cfg = FaultConfig(ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)

    def train_loop(start_step: int) -> int:
        params = M.init_params(cfg, 0, device=dev)
        opt = init_opt_state(params, opt_cfg)
        extra = {"data_step": 0}
        if start_step > 0:
            (params, opt), extra = C.restore(args.ckpt_dir, (params, opt))
        watchdog = StragglerWatchdog(fault_cfg.step_deadline_s)
        data_step = int(extra.get("data_step", 0))

        for step in range(start_step, args.steps):
            tokens, labels = batch_at(data_cfg, data_step, device=dev)
            t0 = time.time()
            metrics, params, opt = step_fn(params, opt,
                                           {"tokens": tokens,
                                            "labels": labels})
            loss = float(metrics["loss"])      # waits for the step
            watchdog.observe(time.time() - t0)
            data_step += 1
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"ce {float(metrics['ce']):.4f} "
                      f"({time.time() - t0:.2f}s)")
            if (step + 1) % fault_cfg.ckpt_every == 0 or \
                    step == args.steps - 1:
                C.save(args.ckpt_dir, step + 1, (params, opt),
                       extra={"data_step": data_step})
        return args.steps

    return run_with_restarts(train_loop, fault_cfg)


if __name__ == "__main__":
    main()
