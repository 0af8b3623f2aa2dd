"""The port's token (seq) axis (``parallel.token_shard``,
``parallel/tokens.py``) on the CPU: 4 gloo ranks, spawned with a file
store, laid out as ``(data, seq)`` meshes, against the JAX package over
the same mesh of its 8 CPU devices and against one process over the same
global batch and token grid.

* JAX's own test of the axis (tests/test_scan_extra.py): img 32, patch 8
  (a 4 × 4 grid), depth 2, embed 64, d_state 4, B = 4, over ``data=1,
  seq=4`` here (one grid row a rank, so a halo spans several ranks) and
  over ``make_mesh(data=2, seq=4)`` in JAX (``layer_fused="off"``,
  ``scan_impl="ref"``): the logits within 1e-4 of JAX's and 1e-5 of one
  process's; the feature maps (``out_indices`` 0, 1, 3) likewise;
* a supervised AdamW step with EMA over ``data=2, seq=2`` against JAX's
  ``make_supervised_train_step`` over ``make_mesh(data=2, seq=2)`` (the
  loss to rtol 1e-4, the parameters and the EMA to rtol = atol = 1e-4,
  as tests/test_torch_port_parallel.py holds them);
* against one process, to 1e-5 (fp32 sums in another order), every
  rank's parameters bitwise equal: two SGD steps with mixup + cutmix +
  DropPath, with and without ``remat``; a ragged 5 × 6 grid (2 and 3 rows
  a rank); ``collapse_method="max"``; the final pools "none", "max",
  "all" and the features with dropout after the position embedding; the
  feature maps' gradients; and the cases whose tokens stay whole (a
  middle cls token, L = 9 over seq 2);
* the max over the group with ties against ``amax``'s gradient;
* the mesh's layout, ``token_shard``'s rule, the bf16 all-reduce's
  refusal on a seq mesh, and ``dryrun_multichip(4, device="cpu")`` over
  ``{'data': 2, 'seq': 2}``.

The ranks run every scenario in one spawn (tests/torch_seq_ranks.py,
which imports no JAX), once a module, while this process computes the
one-process results and JAX's.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvim_tpu.parallel.mesh as jmesh
from fastvim_tpu.models import create_model as jax_create_model
from fastvim_tpu.train import optim as joptim
from fastvim_tpu.train import schedules as jsched
from fastvim_tpu.train.state import TrainState as JaxTrainState
from fastvim_tpu.train.trainer import (
    make_supervised_train_step as jax_make_train_step,
)
from fastvim_tpu_torch.parallel import Mesh, TokenShard, make_mesh, token_shard
from fastvim_tpu_torch.parallel import mesh as pmesh
from fastvim_tpu_torch.utils import from_jax_params, to_jax_params

import torch_seq_ranks as ranks

B = 4
# the scenarios one process runs for the comparison
HERE = ("forward", "features", "max_ties", "mixup", "remat", "ragged",
        "maxpool", "pools", "vim_cls", "indivisible", "helpers")
EQUAL_TO_ONE = ("mixup", "remat", "ragged", "maxpool", "vim_cls",
                "indivisible")
JAX_PATH = dict(layer_fused="off", scan_impl="ref")


def _inputs():
    rng = np.random.default_rng(0)
    image = lambda *hw: rng.standard_normal((B, *hw, 3)).astype(np.float32)
    label = lambda: rng.integers(0, ranks.CLASSES, B)
    return {"weights": ranks.init_weights(),
            "jax_batch": {"image": image(32, 32)},
            "batch": {"image": image(32, 32), "label": label()},
            "ragged_batch": {"image": image(40, 48), "label": label()},
            "small_batch": {"image": image(24, 24), "label": label()},
            # three values over four rows: most maxima are tied
            "ties": rng.integers(0, 3, (2, 4, 3, 5)).astype(np.float32),
            "ties_cotangent": rng.standard_normal((2, 3, 5)).astype(
                np.float32)}


def _jparams(weights):
    return jax.tree_util.tree_map(jnp.asarray, to_jax_params(weights))


def _jax_results(inputs):
    """JAX over the 8 CPU devices: the forward and the feature maps over
    (data 2, seq 4), the AdamW step over (data 2, seq 2)."""
    weights = inputs["weights"]
    old = jmesh._MESH
    out = {}
    try:
        mesh = jmesh.make_mesh(data=2, seq=4)
        x = jmesh.shard_batch(inputs["jax_batch"], mesh)["image"]
        model = jax_create_model("fastvim_tiny", **JAX_PATH,
                                 **ranks.JAX_TEST)
        out["forward"] = np.asarray(jax.jit(model.apply)(
            _jparams(weights["forward"]), x))
        model = jax_create_model("fastvim_tiny", **JAX_PATH, **dict(
            ranks.JAX_TEST, depth=4, num_classes=0, out_indices=(0, 1, 3)))
        out["features"] = [np.asarray(m) for m in jax.jit(model.apply)(
            _jparams(weights["features"]), x)]

        mesh = jmesh.make_mesh(data=2, seq=2)
        model = jax_create_model("fastvim_tiny", **JAX_PATH, **ranks.STEP)
        params = _jparams(weights["step"])
        tx = joptim.make_optimizer(
            jsched.cosine_with_warmup(2e-3, 1e-5, 20, 3, 5e-4),
            weight_decay=0.05, params=params)
        state = JaxTrainState.create(params, tx, ema=True)
        step = jax_make_train_step(model, ranks.CLASSES, label_smoothing=0.1,
                                   ema_decay=0.9)
        state, m = step(state, jmesh.shard_batch(inputs["batch"], mesh),
                        jax.random.PRNGKey(0))
        out["step"] = {"loss": float(m["train_loss"]),
                       "params": from_jax_params(state.params),
                       "ema": from_jax_params(state.ema_params)}
    finally:
        jmesh._MESH = old
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as each rank has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, one process's results, JAX's, the 4 ranks' results)."""
    inputs = _inputs()
    tmp = str(tmp_path_factory.mktemp("seq"))
    four, (here, want) = ranks.spawn(
        list(ranks.SCENARIOS), inputs, tmp,
        meanwhile=lambda: (ranks.run_here(HERE, inputs),
                           _jax_results(inputs)))
    return inputs, here, want, four


def _flat(tensors, keys):
    return np.concatenate([np.ravel(tensors[k]).astype(np.float64)
                           for k in keys])


def _allclose(got, want, tol, what):
    """Every entry within tol + tol·|want| (checked at once; on failure
    tensor by tensor, to name it)."""
    keys = sorted(want)
    assert sorted(got) == keys, what
    g, w = _flat(got, keys), _flat(want, keys)
    if not np.all(np.abs(g - w) <= tol + tol * np.abs(w)):
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                       err_msg=f"{what} {k}")


def _ranks_equal(four, name, key="params"):
    first = four[0][name][key]
    keys = sorted(first)
    for r in range(1, ranks.WORLD):
        assert np.array_equal(_flat(four[r][name][key], keys),
                              _flat(first, keys)), (
            f"{name} {key}: rank {r} differs from rank 0")


def test_forward_matches_jax_over_data2_seq4(runs):
    """JAX's own test configuration, one grid row a rank: every rank
    returns the whole batch's logits."""
    _, here, want, four = runs
    for r in range(ranks.WORLD):
        got = four[r]["forward"]["logits"]
        assert got.shape == (B, 5)
        np.testing.assert_allclose(got, want["forward"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got, here["forward"]["logits"],
                                   rtol=1e-5, atol=1e-5)


def test_feature_maps_match_jax_and_one_process(runs):
    """The maps at out_indices 0, 1, 3 (odd: the transposed orientation),
    gathered to (batch, rows, cols, d) on every rank; their gradients
    against one process's."""
    _, here, want, four = runs
    for r in range(ranks.WORLD):
        got = four[r]["features"]["maps"]
        assert len(got) == len(want["features"]) == 3
        for g, w, h in zip(got, want["features"],
                           here["features"]["maps"]):
            assert g.shape == (B, 4, 4, 64)
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(g, h, rtol=1e-5, atol=1e-5)
        _allclose(four[r]["features"]["grads"], here["features"]["grads"],
                  1e-5, f"feature map gradients rank {r}")


def test_step_matches_jax_over_data2_seq2(runs):
    _, _, want, four = runs
    for r in range(ranks.WORLD):
        got = four[r]["step"]
        np.testing.assert_allclose(got["metrics"]["train_loss"],
                                   want["step"]["loss"], rtol=1e-4)
        _allclose(got["params"], want["step"]["params"], 1e-4, "params")
        _allclose(got["ema"], want["step"]["ema"], 1e-4, "ema")
    _ranks_equal(four, "step")
    _ranks_equal(four, "step", "ema")


@pytest.mark.parametrize("name", EQUAL_TO_ONE)
def test_seq_ranks_equal_one_process(runs, name):
    """Two SGD steps over (data 2, seq 2): the metrics, parameters and
    EMA of one process within 1e-5, every rank's bitwise equal."""
    _, here, _, four = runs
    want = here[name]
    for r in range(ranks.WORLD):
        got = four[r][name]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                       err_msg=f"{name} rank {r} {k}")
        _allclose(got["params"], want["params"], 1e-5, f"{name} rank {r}")
        _allclose(got["ema"], want["ema"], 1e-5, f"{name} ema rank {r}")
    _ranks_equal(four, name)
    _ranks_equal(four, name, "ema")


@pytest.mark.parametrize("pool", ["none", "max", "all", "features"])
def test_final_pools_equal_one_process(runs, pool):
    """The outputs of each final pool (made whole on every rank) and the
    gradients of a fixed projection of them, with dropout 0.2 after the
    position embedding."""
    _, here, _, four = runs
    want = here["pools"][pool]
    for r in range(ranks.WORLD):
        got = four[r]["pools"][pool]
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        assert got["out"].shape == want["out"][rows].shape
        np.testing.assert_allclose(got["out"], want["out"][rows], rtol=1e-5,
                                   atol=1e-5)
        _allclose(got["grads"], want["grads"], 1e-5, f"{pool} rank {r}")


def test_max_over_the_group_shares_ties_as_amax(runs):
    """The max over 4 ranks' rows (one each) of integers with ties: the
    max, and each rank's rows of the gradient, S = 4 times one process's
    (each rank differentiates the group's summed loss)."""
    inputs, here, _, four = runs
    want = here["max_ties"]
    tied = (inputs["ties"] == inputs["ties"].max(1, keepdims=True)).sum(1)
    assert (tied > 1).mean() > 0.3  # the check covers ties
    for r in range(ranks.WORLD):
        got = four[r]["max_ties"]
        np.testing.assert_array_equal(got["max"], want["max"])
        grad = got["grad"]
        np.testing.assert_allclose(grad[:, r], 4 * want["grad"][:, r],
                                   rtol=1e-6)
        assert not np.delete(grad, r, axis=1).any()


# what rank r (data index r // 2) holds of each helper's one-process
# result: the whole of it (None), its data index's rows, or, for the
# denominator, the global count divided by the data size (2)
HELPERS = {"sum_over_ranks": None, "gather_objects": None,
           "batch_moments": None, "mean_over_ranks": None,
           "mirror_rows": "rows", "rand_rows": "rows", "denominator": 2}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helpers_count_each_seq_group_once(runs, name):
    """``parallel.collectives`` over (data 2, seq 2) against one process
    on the global batch: sums, gathers, moments and means over the data
    group's samples, each once; draws and mixup's partner by data
    index."""
    _, here, _, four = runs
    want = here["helpers"][name]
    for r in range(ranks.WORLD):
        got = four[r]["helpers"][name]
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        if HELPERS[name] == "rows":
            np.testing.assert_array_equal(got, want[rows])
        elif HELPERS[name] is None:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(got * HELPERS[name], want, rtol=1e-6)


def test_mesh_layout_and_token_rows(runs):
    """make_mesh(2, 2): rank r at (r // 2, r % 2), its batch rows by data
    index, its grid rows by seq index."""
    *_, four = runs
    for r in range(ranks.WORLD):
        got = four[r]["mesh_layout"]
        d, s = divmod(r, 2)
        assert got["shape"] == {"data": 2, "seq": 2}
        assert (got["data_index"], got["seq_index"]) == (d, s)
        assert got["batch_rows"] == str(slice(2 * d, 2 * d + 2))
        assert got["token_rows"] == str(slice(2 * s, 2 * s + 2))


def test_bf16_allreduce_refuses_a_seq_mesh(runs):
    *_, four = runs
    for r in range(ranks.WORLD):
        assert "seq" in four[r]["bf16_raise"]["raised"]


@pytest.mark.parametrize("grid,cls_token,pooled,seq,rows", [
    ((4, 4), False, True, 2, [slice(0, 2), slice(2, 4)]),
    ((5, 6), False, True, 2, [slice(0, 2), slice(2, 5)]),
    ((4, 4), False, True, 4, [slice(i, i + 1) for i in range(4)]),
    ((4, 4), True, True, 2, None),     # a cls token
    ((3, 3), False, True, 2, None),    # L = 9 over seq 2
    ((1, 4), False, True, 2, None),    # fewer rows than ranks
    ((4, 4), False, False, 2, None),   # the full-length scan
    ((2, 2, 2), False, True, 2, None),  # a 3-D grid
    ((4, 4), False, True, 1, None),    # no seq axis
])
def test_token_shard_rule(grid, cls_token, pooled, seq, rows):
    """Which grids shard, and each rank's contiguous rows (split as
    Mesh.rows splits a batch)."""
    for r in range(seq):
        mesh = Mesh(2 * seq, seq + r, "gloo", seq)
        shard = token_shard(grid, cls_token, pooled, mesh)
        if rows is None:
            assert shard is None
            continue
        assert isinstance(shard, TokenShard)
        assert (shard.index, shard.size, shard.grid) == (r, seq, grid)
        assert shard.rows() == rows[r]
        assert shard.tokens() == slice(rows[r].start * grid[1],
                                       rows[r].stop * grid[1])
        assert shard.last == (r == seq - 1)
        assert mesh.rows(8) == slice(4, 8) and mesh.shape == {
            "data": 2, "seq": seq}


def test_make_mesh_seq_without_the_ranks_raises():
    """One process: a seq axis of 2 names the ranks it needs."""
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(seq=2)
    with pytest.raises(ValueError, match="needs 8 processes"):
        make_mesh(data=4, seq=2)
    assert pmesh.get_mesh().shape == {"data": 1, "seq": 1}


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of one rank, here."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
        rank=0)
    yield
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("method", ["mean", "max"])
def test_functions_on_one_rank_equal_the_plain_ops(one_rank_group,
                                                   transposed, method):
    """Each function of parallel/tokens.py over a one-rank group against
    the whole-grid op it stands for (the conv's halo then wraps within
    the rank), outputs and gradients."""
    for name, got, want in ranks.one_rank_functions(
            torch.device("cpu"), torch.float32, transposed, method, "gloo"):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                                   msg=name)


def test_dryrun_multichip_four_ranks(capfd):
    from fastvim_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    losses = re.findall(r"dryrun_multichip\(4\) (?:step|fused layer): "
                        r"mesh=\{'data': 2, 'seq': 2\} loss=(\S+) step=1",
                        out)
    assert len(losses) == 2, out
    assert all(math.isfinite(float(v)) for v in losses), losses
