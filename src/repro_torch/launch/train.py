"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b

trains random-weight ``--arch`` at full width on one GPU, 2 sequences of
1,024 tokens a step (what one H100 holds with f32 master parameters and
AdamW moments).  ``--offload`` runs the step through the offload
compiler (``--offload-mode`` picks its decision backend) and prints the
plans' decisions.  The step is compiled (``compile_train_step``): the
launcher prints ``train_traces``, the first step's warm call and capture
seconds and the graph pool's bytes.  ``--local`` trains the reduced
config on 4 x 128 tokens instead; ``--device cpu`` runs the plain
PyTorch path on the CPU (the kernels need the GPU).  One device, no
mesh, no checkpoints (they arrive with the durability slice).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import (
    ARCH_IDS,
    ShapeConfig,
    TrainConfig,
    get_config,
    reduced,
)
from repro_torch.core.offload import bwd_plan_stats
from repro_torch.core.policy import PLANNER_MODES, OffloadPolicy
from repro_torch.train import train


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--local", action="store_true",
                    help="train the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--offload", action="store_true",
                    help="run the train step through the offload compiler")
    ap.add_argument("--offload-mode", default=None,
                    choices=list(PLANNER_MODES),
                    help="offload decision backend (implies --offload)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.local:
        cfg = reduced(cfg)
        shape = ShapeConfig("local", 128, 4, "train")
    else:
        shape = ShapeConfig("train_1k", 1024, 2, "train")
    offload = args.offload or args.offload_mode is not None
    tcfg = TrainConfig(total_steps=args.steps, offload=offload,
                       offload_policy=OffloadPolicy(mode=args.offload_mode)
                       if args.offload_mode else None)
    held = []
    _, history = train(cfg, shape, tcfg, device=args.device, log_every=1,
                       on_step=held.append)
    print(f"trained {len(history)} steps: loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f}")
    step = held[0]
    graph = step.graph
    built = "eager (no CUDA graph on this device)" if graph is None else (
        f"warm step + capture {graph.seconds:.1f} s (warm "
        f"{graph.warm_seconds:.1f} s), graph pool "
        f"{graph.memory['reserved'][1] - graph.memory['reserved'][0]} bytes")
    print(f"compiled step: train_traces {step.counters['train_traces']}, "
          f"{built}")
    if offload:
        print(f"backward plans: {bwd_plan_stats().as_dict()}")
    print("done")


if __name__ == "__main__":
    main()
