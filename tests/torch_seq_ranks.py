"""The rank side of tests/test_torch_port_seq.py: forwards and train steps
that run the same in one process (the whole global batch, the whole
token grid) and in each of 4 spawned gloo ranks laid out as a ``(data,
seq)`` mesh (its rows of the batch, its rows of the token grid), and the
spawner.

This module imports no JAX: spawned ranks import it, and only it (with
``torch_parallel_ranks``, whose helpers it shares). Each scenario takes
the inputs the test wrote (weights, batches, as numpy arrays) and returns
what the test compares, as numpy arrays and floats.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.multiprocessing as mp

import torch_parallel_ranks as base
from fastvim_tpu_torch.parallel import (
    allreduce_grads,
    get_mesh,
    init_distributed,
    make_mesh,
    reset_mesh,
    shard_batch,
)
from fastvim_tpu_torch.parallel import tokens

WORLD = 4
CLASSES = 10
# the JAX package's own test of the axis (tests/test_scan_extra.py): a
# 4 × 4 grid, one grid row a rank over seq 4
JAX_TEST = dict(img_size=32, patch_size=8, depth=2, embed_dim=64,
                num_classes=5, drop_path_rate=0.0, ssm_cfg=dict(d_state=4))
# the train steps: the same grid, two rows a rank over seq 2
STEP = dict(JAX_TEST, num_classes=CLASSES)
# a 5 × 6 grid: 2 and 3 rows over seq 2
RAGGED = dict(img_size=(40, 48), patch_size=8, depth=3, embed_dim=32,
              num_classes=CLASSES, drop_path_rate=0.0,
              ssm_cfg=dict(d_state=4))


def _fastvim(**kw):
    return base._registry("fastvim_tiny", **kw)


MODELS = {
    "forward": lambda: _fastvim(**JAX_TEST),
    "step": lambda: _fastvim(**STEP),
    "mixup": lambda: _fastvim(**dict(STEP, drop_path_rate=0.3)),
    "remat": lambda: _fastvim(**dict(STEP, drop_path_rate=0.3, remat=True)),
    "ragged": lambda: _fastvim(**RAGGED),
    "maxpool": lambda: _fastvim(**dict(RAGGED, collapse_method="max")),
    "pools": lambda: _fastvim(**dict(STEP, depth=3, embed_dim=32)),
    "features": lambda: _fastvim(**dict(JAX_TEST, depth=4, num_classes=0,
                                         out_indices=(0, 1, 3))),
    # the tokens stay whole: a middle cls token; L = 9 over seq 2
    "vim_cls": lambda: base._registry(
        "vim_tiny_midclstok", **dict(STEP, embed_dim=32)),
    "indivisible": lambda: _fastvim(**dict(STEP, img_size=24)),
}

# each scenario's (data, seq) mesh
MESHES = {"forward": (1, 4), "features": (1, 4), "max_ties": (1, 4)}


def init_weights() -> Dict[str, Dict[str, np.ndarray]]:
    """Every scenario model's initial weights."""
    return {name: base._numpy(base._build(make(), None).state_dict())
            for name, make in MODELS.items()}


def _model(name: str, inp) -> torch.nn.Module:
    return base._build(MODELS[name](), inp["weights"][name]).train()


def _batch(inp, key: str = "batch") -> Dict[str, torch.Tensor]:
    return shard_batch(base._tensors(inp[key]))


def forward(inp) -> dict:
    """Eval-mode logits of this rank's rows (JAX's test: B = 4)."""
    model = _model("forward", inp).eval()
    with torch.no_grad():
        return {"logits": model(_batch(inp, "jax_batch")["image"]).numpy()}


def features(inp) -> dict:
    """The feature maps (batch, rows, cols, d) at out_indices 0, 1, 3, and
    the gradient of a fixed projection of them."""
    model = _model("features", inp)
    maps = model(_batch(inp, "jax_batch")["image"])
    gen = torch.Generator().manual_seed(9)
    loss = sum((m * torch.randn(m.shape[1:], generator=gen)).sum()
               for m in maps) / maps[0].shape[0]
    names = [n for n, _ in model.named_parameters()]
    grads = allreduce_grads(dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters())))))
    return {"maps": [m.detach().numpy() for m in maps],
            "grads": base._numpy(grads)}


def step(inp) -> dict:
    """One AdamW step with EMA, without mixup or DropPath (the step the
    test runs in JAX over a (2, 2) mesh)."""
    from fastvim_tpu_torch.train import make_supervised_train_step

    model = _model("step", inp)
    state = base._adamw(model, ema=True)
    train_step = make_supervised_train_step(model, CLASSES,
                                            label_smoothing=0.1,
                                            ema_decay=0.9)
    state, metrics = train_step(state, _batch(inp))
    return base._outcome(state, metrics)


def _two_steps(name: str, inp, mixup=True, key="batch") -> dict:
    """Two SGD steps with EMA (mixup, then cutmix, where ``mixup``)."""
    from fastvim_tpu_torch.train import make_supervised_train_step

    model = _model(name, inp)
    state = base._sgd(model, ema=True)
    batch = _batch(inp, key)
    metrics = {}
    for switch in (0.0, 1.0):
        train_step = make_supervised_train_step(
            model, CLASSES, mixup_config=dict(
                mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=switch)
            if mixup else None, label_smoothing=0.1, ema_decay=0.9,
            generator=torch.Generator().manual_seed(5))
        state, m = train_step(state, batch)
        metrics.update({f"{k}_{switch}": v for k, v in m.items()})
    return base._outcome(state, metrics)


def mixup(inp) -> dict:
    """Mixup + cutmix + DropPath 0.3 through two SGD steps."""
    return _two_steps("mixup", inp)


def remat(inp) -> dict:
    """``mixup`` with ``remat=True``: each block recomputed in the
    backward pass, its halo exchanges and gathers called again."""
    return _two_steps("remat", inp)


def ragged(inp) -> dict:
    """A 5 × 6 grid (2 and 3 rows a rank), two SGD steps."""
    return _two_steps("ragged", inp, mixup=False, key="ragged_batch")


def maxpool(inp) -> dict:
    """``ragged`` with ``collapse_method="max"``."""
    return _two_steps("maxpool", inp, mixup=False, key="ragged_batch")


def pools(inp) -> dict:
    """The other final pools ("none": the last rank's last token; "max"
    and "all": the head on every token; the features of "mean"), each
    with the gradient of a fixed projection of its output; dropout 0.2
    after the position embedding (its mask drawn over the whole grid)."""
    model = _model("pools", inp)
    model.pos_drop.rate = 0.2
    x = _batch(inp)["image"]
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for pool in ("none", "max", "all", "features"):
        model.set_drop_path_generator(torch.Generator().manual_seed(6))
        model.final_pool_type = "mean" if pool == "features" else pool
        y = model(x, return_features=pool == "features")
        proj = torch.randn(y.shape[1:],
                           generator=torch.Generator().manual_seed(7))
        loss = (y * proj).sum() / y.shape[0]  # a mean over the batch
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = allreduce_grads({  # the features leave the head unused
            k: torch.zeros_like(p) if g is None else g
            for k, p, g in zip(names, params, grads)})
        out[pool] = {"out": y.detach().numpy(), "grads": base._numpy(grads)}
    return out


def vim_cls(inp) -> dict:
    """A middle-cls-token Vim: its tokens stay whole."""
    return _two_steps("vim_cls", inp, mixup=False)


def indivisible(inp) -> dict:
    """A 3 × 3 grid (L = 9 over seq 2): its tokens stay whole."""
    return _two_steps("indivisible", inp, mixup=False, key="small_batch")


def max_ties(inp) -> dict:
    """The max over the group's rows of (batch, rows, cols, d) integers,
    many of them tied, and its gradient against a fixed cotangent: the
    whole grid's ``amax`` over rows, and its gradient, one process's."""
    from fastvim_tpu_torch.parallel.mesh import token_shard

    x = torch.as_tensor(inp["ties"]).requires_grad_(True)
    cot = torch.as_tensor(inp["ties_cotangent"])
    shard = token_shard(x.shape[1:3])
    if shard is None:
        m = x.amax(1)
        local = x
    else:
        local = x[:, shard.rows()]
        m = tokens._Max.apply(local, shard, 1)
    (g,) = torch.autograd.grad((m * cot).sum(), x)
    return {"max": m.detach().numpy(), "grad": g.numpy()}


def helpers(inp) -> dict:
    """``parallel.collectives``' helpers on this rank's rows of the
    batch: over (data 2, seq 2) each seq group's pair of ranks holds the
    same rows, and each helper must count them once."""
    from fastvim_tpu_torch.parallel import (
        batch_moments,
        denominator,
        gather_objects,
        mean_over_ranks,
        mirror_rows,
        rand_rows,
        sum_over_ranks,
    )

    x = _batch(inp)["image"]
    mean, mean_sq = batch_moments(x, (0, 1, 2))
    return {"sum_over_ranks": sum_over_ranks(x.sum(0)).numpy(),
            "gather_objects": np.array(gather_objects(x[:, 0, 0, 0].tolist())),
            "batch_moments": torch.stack([mean, mean_sq]).numpy(),
            "denominator": denominator((x > 0).sum()).numpy(),
            "mean_over_ranks": mean_over_ranks({"m": x.mean()})["m"].numpy(),
            "mirror_rows": mirror_rows(x).numpy(),
            "rand_rows": rand_rows((x.shape[0], 3),
                                   torch.Generator().manual_seed(11),
                                   x.device).numpy()}


def bf16_raise(inp) -> dict:
    """``grad_allreduce_dtype=torch.bfloat16`` on a seq mesh raises."""
    from fastvim_tpu_torch.train import make_supervised_train_step

    try:
        make_supervised_train_step(_model("step", inp), CLASSES,
                                   grad_allreduce_dtype=torch.bfloat16)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": ""}


def mesh_layout(inp) -> dict:
    """This rank's place in the mesh, its batch rows and token rows."""
    mesh = get_mesh()
    shard = _model("step", inp).token_shard(torch.zeros(4, 32, 32, 3))
    return {"shape": dict(mesh.shape), "data_index": mesh.data_index,
            "seq_index": mesh.seq_index, "batch_rows": str(mesh.rows(4)),
            "token_rows": str(None if shard is None else shard.rows())}


def one_rank_functions(device, dtype, transposed: bool, method: str,
                       backend: str) -> list:
    """Each function of ``parallel/tokens.py`` on a one-rank group (the
    process group must be up, of world 1) against its plain
    single-process counterpart, on a 5 × 7 grid: [(name, got, want)],
    the outputs and the gradients of a seeded projection of them with
    respect to the inputs. With one rank the halo of a transposed conv
    wraps to the previous column's last rows on the same rank."""
    from fastvim_tpu_torch.ops.conv import grid_dual_conv1d
    from fastvim_tpu_torch.ops.scan import broadcast_grid, pool_grid
    from fastvim_tpu_torch.parallel.mesh import TokenShard

    gen = torch.Generator().manual_seed(3)
    B, H, W, d = 2, 5, 7, 16
    rand = lambda *s: torch.randn(*s, generator=gen).to(device, dtype)
    shard = TokenShard((H, W), 0, 1, None, backend)
    pool_axes = (0,) if transposed else (1,)
    pooled = W if transposed else H
    cases = {
        "halo_dual_conv": (
            lambda x, wc, bc, wa, ba: tokens.halo_dual_conv(
                x, wc, bc, wa, ba, shard, transposed),
            lambda x, wc, bc, wa, ba: grid_dual_conv1d(
                x, wc, bc, wa, ba, (H, W), axis=0 if transposed else 1),
            (rand(B, H * W, d), rand(4, d), rand(d), rand(4, d), rand(d))),
        "pool_whole": (
            lambda x: tokens.pool_whole(x, shard, transposed, method, 0.5),
            lambda x: pool_grid(x, (H, W), pool_axes, method, 0.5),
            (rand(B, H * W, d),)),
        "local_rows": (
            lambda y: tokens.local_rows(y, shard, transposed),
            lambda y: broadcast_grid(y, (H, W), pool_axes),
            (rand(B, pooled, d),)),
        "mean_tokens": (lambda x: tokens.mean_tokens(x, shard),
                        lambda x: x.mean(1), (rand(B, H * W, d),)),
        "last_token": (lambda x: tokens.last_token(x, shard),
                       lambda x: x[:, -1], (rand(B, H * W, d),)),
        "gather_tokens": (lambda x: tokens.gather_tokens(x, shard),
                          lambda x: x, (rand(B, H * W, d),)),
        "gather_rows": (lambda x: tokens.gather_rows(x, shard),
                        lambda x: x, (rand(B, H, W, d),)),
    }
    out = []
    for name, (fn, plain, args) in cases.items():
        for which, f in (("got", fn), ("want", plain)):
            inputs = [a.detach().clone().requires_grad_(True) for a in args]
            ys = f(*inputs)
            ys = ys if isinstance(ys, tuple) else (ys,)
            cot = torch.Generator().manual_seed(4)
            loss = sum((y.float() * torch.randn(y.shape, generator=cot).to(
                device)).sum() for y in ys)
            grads = torch.autograd.grad(loss, inputs)
            res = [y.detach() for y in ys] + list(grads)
            if which == "got":
                got = res
        out += [(f"{name}[{i}]", g, w) for i, (g, w) in enumerate(zip(got,
                                                                       res))]
    return out


SCENARIOS: Dict[str, Callable[[dict], dict]] = {
    f.__name__: f for f in (forward, features, max_ties, step, mixup, remat,
                            ragged, maxpool, pools, vim_cls, indivisible,
                            helpers, bf16_raise, mesh_layout)}


def _rank_main(rank: int, world: int, store: str, names: List[str],
               inputs: str, out: str) -> None:
    """Rank ``rank``: the scenarios, each on its own ``(data, seq)`` mesh
    (by default (2, 2)) of one process group."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    inp = torch.load(inputs, weights_only=True)
    init_distributed("cpu", init_method=f"file://{store}",
                     world_size=world, rank=rank)
    results = {}
    for name in names:
        make_mesh(*MESHES.get(name, (2, 2)))
        results[name] = SCENARIOS[name](inp)
    dist.destroy_process_group()
    reset_mesh()
    torch.save(base._as_torch(results), os.path.join(out, f"rank{rank}.pt"))


def spawn(names: List[str], inputs: dict, tmp: str, meanwhile=None):
    """Run the scenarios ``names`` in ``WORLD`` spawned gloo ranks and
    ``meanwhile()`` here while they run. Returns (each rank's results in
    rank order, what ``meanwhile`` returned)."""
    path = os.path.join(tmp, "inputs.pt")
    torch.save(base._as_torch(inputs), path)
    ctx = mp.spawn(_rank_main, args=(WORLD, os.path.join(tmp, "store"),
                                     names, path, tmp),
                   nprocs=WORLD, join=False)
    try:
        here = meanwhile() if meanwhile is not None else None
    finally:
        while not ctx.join():
            pass
    return [base._as_numpy(torch.load(os.path.join(tmp, f"rank{r}.pt"),
                                      weights_only=True))
            for r in range(WORLD)], here


def run_here(names: List[str], inputs: dict) -> dict:
    """The scenarios in this process: one rank, no process group."""
    return {name: SCENARIOS[name](inputs) for name in names}
