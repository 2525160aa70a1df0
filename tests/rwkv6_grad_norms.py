"""rwkv6-1.6b at full width and a few layers, f32, on the CPU: the JAX
package's jitted step against the port's plain eager step (no offload,
``remat`` on, as the card trains it), from the same seed-0 state on the
same 2 x 1,024-token batches.  Prints, for each package, the grad norm of
the initial state on batches 0-2 and the loss and grad norm of 3 steps,
then the relative differences.

Not collected by pytest (minutes at full width); run by hand:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rwkv6_grad_norms.py 2

Each package runs in a process of its own, one after the other (about
10-20 GB of host memory at 2-8 layers).  With ``leaves`` after the layer
count, one process takes both packages' gradients of the initial state on
batch 0 and prints the leaves that differ most (the JAX package's
gradients converted to the port's tree by ``from_jax_params``).
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np

ARCH = "rwkv6-1.6b"
SHAPE = (1024, 2)      # seq_len, global batch
STEPS = 3


def _jax(layers: int) -> dict:
    import jax

    from repro.configs import TrainConfig
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_config
    from repro.data import SyntheticLM, make_data_config
    from repro.models import build_model
    from repro.train.step import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(ARCH), num_layers=layers,
                              dtype="float32")
    state = init_train_state(build_model(cfg), jax.random.PRNGKey(0))
    data = SyntheticLM(make_data_config(cfg, ShapeConfig("chip", *SHAPE,
                                                         "train")))
    step = jax.jit(make_train_step(build_model(cfg), TrainConfig(remat=True)))
    init = [float(step(state, data.batch(i))[1]["grad_norm"])
            for i in range(STEPS)]
    steps = []
    for i in range(STEPS):
        state, m = step(state, data.batch(i))
        steps.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return dict(init=init, steps=steps)


def _torch(layers: int) -> dict:
    import jax
    import torch

    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_config as jget_config
    from repro.data import SyntheticLM, make_data_config
    from repro.models import build_model as jbuild_model
    from repro.train.step import init_train_state as jinit_train_state
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.convert import from_jax_train_state
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Ties
    from repro_torch.optim import global_norm
    from repro_torch.train import make_train_step

    jcfg = dataclasses.replace(jget_config(ARCH), num_layers=layers,
                               dtype="float32")
    jstate = jax.tree.map(np.asarray, jinit_train_state(
        jbuild_model(jcfg), jax.random.PRNGKey(0)))
    data = SyntheticLM(make_data_config(jcfg, ShapeConfig("chip", *SHAPE,
                                                          "train")))
    batches = [data.batch(i) for i in range(STEPS)]
    cfg = dataclasses.replace(get_config(ARCH), num_layers=layers,
                              dtype="float32")
    state = from_jax_train_state(jstate, cfg, device="cpu")
    del jstate
    step = make_train_step(build_model(cfg, device="cpu"),
                           TrainConfig(remat=True))
    init = []
    for b in batches:
        _, _, grads = step.compute_grads(state.params, b)
        init.append(float(global_norm(Ties(grads).unique(grads))))
        del grads
    steps = []
    for b in batches:
        state, m = step(state, b)
        steps.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return dict(init=init, steps=steps)


def _leaves(layers: int, top: int = 6) -> None:
    import jax
    import torch

    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_config as jget_config
    from repro.data import SyntheticLM, make_data_config
    from repro.models import build_model as jbuild_model
    from repro.train.step import init_train_state as jinit_train_state
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.convert import from_jax_params, from_jax_train_state
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step

    jcfg = dataclasses.replace(jget_config(ARCH), num_layers=layers,
                               dtype="float32")
    jmodel = jbuild_model(jcfg)
    jstate = jinit_train_state(jmodel, jax.random.PRNGKey(0))
    batch = SyntheticLM(make_data_config(jcfg, ShapeConfig(
        "chip", *SHAPE, "train"))).batch(0)
    jgrads = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(
        p, b, remat=True)[0]))(jstate.params, batch)
    cfg = dataclasses.replace(get_config(ARCH), num_layers=layers,
                              dtype="float32")
    want = from_jax_params(jax.tree.map(np.asarray, jgrads), cfg,
                           device="cpu", dtype=torch.float32)
    state = from_jax_train_state(jax.tree.map(np.asarray, jstate), cfg,
                                 device="cpu")
    del jgrads, jstate
    step = make_train_step(build_model(cfg, device="cpu"),
                           TrainConfig(remat=True))
    _, _, got = step.compute_grads(state.params, batch)
    paths = torch.utils._pytree.tree_flatten_with_path(got)[0]
    rows = []
    for (path, g), w in zip(paths, torch.utils._pytree.tree_leaves(want)):
        diff = float(torch.linalg.vector_norm((g - w).double()))
        norm = float(torch.linalg.vector_norm(w.double()))
        rows.append((diff, norm, "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path)))
    total = sum(d * d for d, _, _ in rows) ** 0.5
    print(f"{ARCH} at {layers} layers, batch 0: |g_port - g_jax| "
          f"{total:.4g} over all leaves; the {top} largest:")
    for diff, norm, name in sorted(rows, reverse=True)[:top]:
        print(f"  {name}: |diff| {diff:.4g}, |g_jax| {norm:.4g} "
              f"(relative {diff / max(norm, 1e-30):.3g})")


def main() -> None:
    layers = int(sys.argv[1])
    if sys.argv[2:] == ["leaves"]:
        _leaves(layers)
        return
    if len(sys.argv) > 2:
        side = {"jax": _jax, "torch": _torch}[sys.argv[2]]
        print(json.dumps(side(layers)))
        return
    got = {}
    for side in ("jax", "torch"):
        out = subprocess.run([sys.executable, __file__, str(layers), side],
                             capture_output=True, text=True, check=True)
        got[side] = json.loads(out.stdout.splitlines()[-1])
        print(f"{side}: {got[side]}")
    j, t = got["jax"], got["torch"]
    rel = [abs(a - b) / abs(a) for a, b in zip(j["init"], t["init"])]
    print(f"{ARCH} at {layers} layers, full width, f32: the initial "
          f"state's grad norm on batches 0-{STEPS - 1}, relative "
          f"difference {rel}")
    for k in ("loss", "grad_norm"):
        rel = [abs(a[k] - b[k]) / abs(a[k])
               for a, b in zip(j["steps"], t["steps"])]
        print(f"{STEPS} steps' {k}: relative difference {rel}")


if __name__ == "__main__":
    main()
