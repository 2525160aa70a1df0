"""``python -m repro_torch.analysis.lint`` — sweep offload plans through
the static verifier.

    PYTHONPATH=src python -m repro_torch.analysis.lint --all-configs
    PYTHONPATH=src python -m repro_torch.analysis.lint --arch zamba2-1.2b -v

``--all-configs`` plans every architecture of ``configs/registry.py`` at
full width, cut to at most 2 layers, for the training loss forward, its
gradient (``torch.func.grad`` of it, captured as one graph) and the
optimizer update with the parameters and moments donated (as the
compiled training step binds it), on a batch of 2 x 128 tokens;
``--arch`` names some.  Nothing is allocated:
the parameters and the batch are fake tensors
(``launch.inputs.abstract_tree`` / ``batch_specs``), which the planner's
capture traces as it traces real ones.  Exit status is non-zero iff a
finding of severity error survives.

The reference's ``--chains`` sweeps the fusion contract of its offload
benchmark (``benchmarks/offload_bench.py``), which the port does not
have; the port's chain contract lives in ``tests/test_torch_offload*.py``.
``docs/torch_analysis.md`` has the rule catalog.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Iterable

import torch

from repro_torch.analysis.verifier import (
    Finding,
    dropped_findings,
    verify_plan,
)

# deep stacks plan the same per-layer segments again: 2 layers cover
# every kernel form a model has
_LINT_LAYERS = 2
_LINT_SEQ = 128
_LINT_BATCH = 2


def _shrunk_config(cfg):
    """A planning-equivalent shallow copy of a registry config."""
    return dataclasses.replace(cfg, num_layers=min(cfg.num_layers,
                                                   _LINT_LAYERS))


def config_targets(archs: Iterable[str] | None = None
                   ) -> Iterable[tuple[str, Callable, tuple, tuple]]:
    """Yield ``(name, fn, fake args, donate_argnums)`` for every registry
    model: the loss forward, its gradient, and the optimizer update with
    the parameters and moments donated, as the compiled training step
    binds it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ARCH_IDS, ShapeConfig, TrainConfig, \
        get_config
    from repro_torch.launch.inputs import abstract_tree, batch_specs
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Ties
    from repro_torch.optim import init_state
    from repro_torch.train.step import UPDATE_DONATE, _unique_opt, \
        update_program

    shape = ShapeConfig("lint", seq_len=_LINT_SEQ, global_batch=_LINT_BATCH,
                        kind="train")
    for arch in (archs or ARCH_IDS):
        cfg = _shrunk_config(get_config(arch))
        model = build_model(cfg, device="cpu")
        mode = FakeTensorMode()
        params = abstract_tree(model.init, 0, fake_mode=mode)
        batch = batch_specs(cfg, shape, fake_mode=mode)

        def fwd(p, b, _loss=model.loss_fn):
            return _loss(p, b, remat=False)[0]

        yield f"{arch}:fwd", fwd, (params, batch), ()
        yield f"{arch}:grad", torch.func.grad(fwd), (params, batch), ()
        ties = Ties(params)
        with mode:
            grads = [torch.zeros_like(p) for p in ties.unique(params)]
            opt = _unique_opt(ties, init_state(params))
        yield (f"{arch}:update", update_program(TrainConfig()),
               (ties.unique(params), grads, opt), UPDATE_DONATE)


def verify_target(fn: Callable, args: tuple,
                  donate: tuple = ()) -> list[Finding]:
    """Plan one target under the default policy (``donate`` its
    ``donate_argnums``) and run the verifier over its plan; the
    donations the planner dropped come as info findings."""
    from repro_torch.core.offload import offload_report

    plan = offload_report(fn, *args, donate_argnums=donate)
    return verify_plan(plan) + dropped_findings(plan)


def run(targets, *, verbose: bool = False) -> int:
    n_err = n_warn = n_targets = 0
    for name, fn, args, donate in targets:
        n_targets += 1
        try:
            findings = verify_target(fn, args, donate)
        except Exception as e:
            print(f"FAIL  {name}: planning raised {type(e).__name__}: {e}")
            n_err += 1
            continue
        errs = [f for f in findings if f.severity == "error"]
        warns = [f for f in findings if f.severity == "warning"]
        n_err += len(errs)
        n_warn += len(warns)
        status = "FAIL" if errs else ("warn" if warns else "ok")
        print(f"{status:4}  {name}  ({len(errs)} error, {len(warns)} "
              "warning)")
        for f in findings if verbose else errs + warns:
            print(f"      {f}")
    print(f"\n{n_targets} target(s): {n_err} error finding(s), {n_warn} "
          "warning(s)")
    return 1 if n_err else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="statically verify the port's offload plans (alias "
                    "safety, index bounds, shared memory and registers on "
                    "the H100, well-formedness)")
    ap.add_argument("--all-configs", action="store_true",
                    help="sweep every configs/ model, fwd + grad")
    ap.add_argument("--arch", action="append", default=[],
                    help="lint specific arch id(s)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print info-severity findings too")
    args = ap.parse_args(argv)
    if not (args.all_configs or args.arch):
        ap.error("nothing to lint: pass --all-configs or --arch")
    return run(config_targets(args.arch or None), verbose=args.verbose)


if __name__ == "__main__":
    sys.exit(main())
