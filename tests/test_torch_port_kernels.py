"""The port's kernel modules (fastvim_tpu_torch/ops/kernels) against the
JAX package, on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version; these
tests hold those versions to the Pallas kernels they stand in for, run in
interpret mode as the JAX package's own tests run them, and to the JAX
references. Inputs are made with numpy from a seed and fed to both sides.
fp32 throughout, rtol = atol = 2e-5 as tests/test_layer_fused.py uses:
both sides do the same fp32 operations in different orders.
"""

import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvim_tpu_torch
from fastvim_tpu.ops.pallas.layer_fused import _fused_fwd_impl, _reference_core
from fastvim_tpu.ops.pallas.selective_scan import selective_scan_pallas
from fastvim_tpu.ops.scan import selective_scan_ref as jax_scan_ref
from fastvim_tpu_torch.ops import kernels
from fastvim_tpu_torch.ops.kernels import _build
from fastvim_tpu_torch.ops.kernels import layer_fused as lf
from fastvim_tpu_torch.ops.kernels import selective_scan as ss
from fastvim_tpu_torch.ops.kernels.layer_fused import (
    FusedParams,
    fusable,
    fused_mixer_core,
)
from fastvim_tpu_torch.ops.scan import selective_scan

TOL = dict(rtol=2e-5, atol=2e-5)
DM, DI, R, N = 64, 128, 4, 16


def _scan_inputs(seed, batch, L, d, n=N):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(u=f(batch, L, d), delta=0.5 * f(batch, L, d),
                A=-np.exp(rng.uniform(-1, 1, (d, n))).astype(np.float32),
                B=f(batch, L, n), C=f(batch, L, n),
                D=rng.uniform(-1, 1, d).astype(np.float32),
                delta_bias=rng.uniform(-0.5, 0.5, d).astype(np.float32))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L,block_l", [(37, 16), (200, 128)])
def test_scan_matches_pallas_and_ref(reverse, L, block_l):
    """K1's plain version (the CPU path of the port's selective_scan) and
    the Pallas kernel in interpret mode (block_l 16 pads L=37 to 3 chunks;
    L=200 is 2 chunks), each against the sequential JAX reference — the
    fp32 oracle, not the associative scan — so that a failure names the
    side that moved."""
    a = _scan_inputs(L, 2, L, 128)
    kw = dict(delta_softplus=True, reverse=reverse)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    # one intra-op thread: torch's CPU exp on a worker thread, beside XLA's
    # CPU runtime in the same process, has come out off in one thread's
    # share of its output (ROADMAP.md, faults found in the port)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"],
                             D=t["D"], delta_bias=t["delta_bias"],
                             **kw).numpy()
    finally:
        torch.set_num_threads(threads)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    pal = selective_scan_pallas(j["u"], j["delta"], j["A"], j["B"], j["C"],
                                D=j["D"], delta_bias=j["delta_bias"],
                                block_l=block_l, block_d=128, interpret=True,
                                **kw)
    ref = jax_scan_ref(j["u"], j["delta"], j["A"], j["B"], j["C"], D=j["D"],
                       delta_bias=j["delta_bias"], **kw)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL,
                               err_msg="the port's scan against the reference")
    np.testing.assert_allclose(np.asarray(pal), np.asarray(ref), **TOL,
                               err_msg="the Pallas kernel against the "
                                       "reference")


def _layer_params(seed, bias=False):
    """The JAX fused layer's parameter tuple (tests/test_layer_fused.py
    layout) from numpy, and the port's FusedParams of the same values."""
    rng = np.random.default_rng(seed)
    u = lambda shape, s=0.2: rng.uniform(-s, s, shape).astype(np.float32)
    p = dict(
        win=u((DM, 2 * DI)), bin_=u((2 * DI,)) if bias else None,
        wcf=u((4, DI)), bcf=u((DI,)), wab=u((4, DI)), bab=u((DI,)),
        xpf=u((DI, R + 2 * N)), dtwf=u((R, DI)), dtbf=u((DI,), 0.5),
        Af=u((DI, N), 1.0), Df=u((DI,)),
        xpb=u((DI, R + 2 * N)), dtwb=u((R, DI)), dtbb=u((DI,), 0.5),
        Ab=u((DI, N), 1.0), Db=u((DI,)),
        lnw=1.0 + u((DI,), 0.1), lnb=u((DI,), 0.1),
        wout=u((DI, DM)), bout=u((DM,)) if bias else None)
    jp = tuple(None if v is None else jnp.asarray(v) for v in p.values())
    t = lambda v: None if v is None else torch.from_numpy(
        np.ascontiguousarray(v))
    tp = FusedParams(
        t(p["win"].T), t(p["bin_"]), t(p["wcf"].T), t(p["bcf"]),
        t(p["wab"].T), t(p["bab"]), t(p["xpf"].T), t(p["dtwf"].T),
        t(p["dtbf"]), t(p["Af"]), t(p["Df"]), t(p["xpb"].T), t(p["dtwb"].T),
        t(p["dtbb"]), t(p["Ab"]), t(p["Db"]), t(p["lnw"]), t(p["lnb"]),
        t(p["wout"].T), t(p["bout"]))
    return jp, tp


def _x(seed, H, W, batch=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, H * W, DM)).astype(np.float32)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("grid", [(8, 8), (8, 24)])
def test_pass_a_pass_b_match_pallas(transposed, grid):
    """Pass A (K3) and pass B (K4) plain versions, chained by
    fused_mixer_core, against the Pallas passes in interpret mode: the
    saved xc_f, xc_b, pf, pb and the layer output."""
    x = _x(1, *grid)
    jp, tp = _layer_params(2)
    args = (grid, transposed, 1.0, 1e-5, True)
    out_j, saved_j = _fused_fwd_impl(jnp.asarray(x), jp, *args, jnp.float32,
                                     "ref", True, return_saved=True)
    out_t, saved_t = fused_mixer_core(torch.from_numpy(x), tp, *args,
                                      torch.float32, return_saved=True)
    for got, want in zip(saved_t[:4], saved_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("grid,bias,use_ln,scaling", [
    ((6, 10), False, True, 1.0),
    ((6, 10), True, False, 0.25),
])
def test_fused_core_matches_reference_unaligned(transposed, grid, bias,
                                                use_ln, scaling):
    """A grid the JAX kernels cannot take (not 8-aligned) runs fused in
    the port; it matches the JAX unfused reference `_reference_core`."""
    assert fusable(grid, (0,) if transposed else (1,), transposed, DM, DI, 4,
                   "mean")
    x = _x(3, *grid)
    jp, tp = _layer_params(4, bias=bias)
    args = (grid, transposed, scaling, 1e-5, use_ln)
    want = _reference_core(jnp.asarray(x), jp, *args, jnp.float32, "ref")
    got = fused_mixer_core(torch.from_numpy(x), tp, *args, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fusable_limits():
    """The real limits of the fused layer, without the TPU layout rules:
    the grid, and the widths the pass A and pass B launchers take."""
    w = (192, 384)  # FastVim-T's d_model, d_inner
    assert fusable((14, 14), (1,), False, *w, 4, "mean")
    assert fusable((14, 14), (0,), True, *w, 4, "mean")
    assert not fusable((14, 14), (0,), False, *w, 4, "mean")
    assert not fusable((14, 14), (1,), False, *w, 4, "max")
    assert not fusable((14, 14), (1,), False, *w, 3, "mean")
    assert not fusable((3, 14), (1,), False, *w, 4, "mean")
    assert not fusable((4, 4, 4), (2,), False, *w, 4, "mean")
    # widths: up to FastVim-H's (d_model 1280, d_inner 2560), K3 owns 64
    # channels
    assert fusable((14, 14), (1,), False, 384, 768, 4, "mean")
    assert fusable((14, 14), (1,), False, 768, 1536, 4, "mean")
    assert fusable((14, 14), (0,), True, 1280, 2560, 4, "mean")
    assert not fusable((14, 14), (1,), False, 1312, 2624, 4, "mean")
    assert not fusable((14, 14), (1,), False, 1280, 2624, 4, "mean")
    assert not fusable((14, 14), (1,), False, 48, 96, 4, "mean")
    assert not fusable((14, 14), (1,), False, 192, 352, 4, "mean")


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the wrappers run the plain versions, forward and
    backward, and launch nothing."""
    kernels.reset_launch_counts()
    x = torch.from_numpy(_x(5, 8, 8))
    _, tp = _layer_params(6)
    fused_mixer_core(x, tp, (8, 8), False, 1.0, 1e-5, True, torch.float32)
    out = fused_mixer_core(x.requires_grad_(), tp, (8, 8), False, 1.0, 1e-5,
                           True, torch.float32)
    out.sum().backward()
    assert x.grad is not None
    assert kernels.launch_counts() == dict.fromkeys(
        ("selective_scan_fwd", "selective_scan_bwd", "pass_a_fwd",
         "pass_b_fwd", "pass_b_bwd", "pass_a_bwd", "pass_b_recompute_fwd",
         "conv_pool_fwd", "merge_gate_fwd", "merge_ln_gate_fwd",
         "selective_scan_fwd_lanes"), 0)


def test_launchers_refuse_grad_requiring_tensors():
    """A raw launch records no autograd graph, so the launchers' argument
    check refuses a tensor that requires grad while grad mode is on; the
    autograd Functions call them with grad mode off."""
    from types import SimpleNamespace

    cuda = torch.device("cuda", 0)
    t = SimpleNamespace(device=cuda, requires_grad=True,
                        is_contiguous=lambda: True)
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.check_cuda_args("selective_scan_bwd", cuda, u=t)
    with torch.no_grad():
        kernels.check_cuda_args("selective_scan_bwd", cuda, u=t, D=None)
    with pytest.raises(ValueError, match="expected cuda:0"):
        kernels.check_cuda_args("pass_b_bwd", cuda, x4=torch.zeros(1))


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device raises: no wrapper
    falls back to its plain version."""
    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ss.selective_scan_fwd(m(1, 8, DI), m(1, 8, DI), m(DI, N), m(1, 8, N),
                              m(1, 8, N))
    with pytest.raises(ValueError, match="unsupported device"):
        lf.pass_a(m(1, 8, 8, DM), m(DI, DM), None, m(DI, 4), None, m(DI, 4),
                  None, 1.0, False)
    with pytest.raises(ValueError, match="unsupported device"):
        lf.pass_b(m(1, 8, 8, DM), m(1, 8, 8, DI), m(1, 8, 8, DI), m(1, 8, DI),
                  m(1, 8, DI), m(DI, DM), None, m(DI), m(DI), m(DI), m(DI),
                  m(DM, DI), None, 1e-5, True, False)
    with pytest.raises(ValueError, match="unsupported device"):
        ss.selective_scan_bwd(m(1, 8, DI), m(1, 8, DI), m(DI, N), m(1, 8, N),
                              m(1, 8, N), None, None, m(1, 8, DI),
                              m(1, 1, DI, N))
    with pytest.raises(ValueError, match="unsupported device"):
        lf.pass_b_bwd(m(1, 8, 8, DM), m(1, 8, 8, DM), m(1, 8, 8, DI),
                      m(1, 8, 8, DI), m(1, 8, DI), m(1, 8, DI), m(DI, DM),
                      None, m(DI), m(DI), m(DI), m(DI), m(DM, DI), 1e-5, True,
                      False)
    with pytest.raises(ValueError, match="unsupported device"):
        lf.pass_a_bwd(m(1, 8, 8, DM), m(1, 8, 8, DM), m(1, 8, 8, DI),
                      m(1, 8, 8, DI), m(1, 8, DI), m(1, 8, DI), m(DI, DM),
                      None, m(DI, 4), None, m(DI, 4), None, 1.0, False)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No nvcc: building the kernel library raises, it does not fall back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", tmp_path / "cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not (tmp_path / "build").exists()


def test_ranks_starting_together_build_once(tmp_path):
    """Four processes (torchrun ranks) asking for the kernel library at
    once: nvcc (a stand-in that writes its output and logs its call) runs
    once a source and links once, and every process gets the same
    library."""
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$*" >> {log}\n'
        'prev=""; for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; '
        'prev="$a"; done\n'
        'sleep 0.3; echo built > "$out"\n')
    nvcc.chmod(0o755)
    code = ("import sys; from pathlib import Path\n"
            "from fastvim_tpu_torch.ops.kernels import _build\n"
            "_build.BUILD_DIR = Path(sys.argv[1])\n"
            "print(_build.build())\n")
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"))
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "build")], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    paths = {p.communicate(timeout=120)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert len(paths) == 1 and Path(paths.pop()).read_text() == "built\n"
    calls = log.read_text().splitlines()
    assert sum("-shared" in c for c in calls) == 1
    assert len(calls) == len(list(_build.CSRC.glob("*.cu"))) + 1


def test_ctypes_signatures_match_sources():
    """The argument types declared for each C entry point match its
    definition in csrc/ (a mismatch would pass pointers as ints)."""
    import ctypes
    import re

    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float}
    found = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            found[name] = [ctype[" ".join(p.split()[:-1]).replace(" *", "*")]
                           for p in params.split(",")]
    assert found == _build.SIGNATURES


def test_port_imports_no_jax():
    """Importing every module of fastvim_tpu_torch pulls in no JAX, and
    neither PIL nor scikit-learn: the card's Python has no scikit-learn,
    so the data modules import both only inside the functions that use
    them (PyYAML is there, and config.py imports it)."""
    mods = [m.name for m in pkgutil.walk_packages(
        fastvim_tpu_torch.__path__, "fastvim_tpu_torch.")]
    assert "fastvim_tpu_torch.ops.kernels.layer_fused" in mods
    assert "fastvim_tpu_torch.train.trainer" in mods
    for m in ("config", "cli.train_classification", "cli.test_classification",
              "data.loader", "data.transforms", "data.digits", "data.device",
              "train.loop", "train.checkpoint", "utils.tboard", "models.mae",
              "cli.pretrain_mae", "cli.finetune_mae", "cli.linear_probe",
              "models.upernet", "models.heads", "train.metrics",
              "data.segmentation", "cli.train_segmentation",
              "cli.extract_features", "ops.boxes", "models.detection",
              "data.detection", "cli.train_detection", "native",
              "native._build", "native.plain", "parallel", "parallel.mesh",
              "parallel.collectives", "parallel.dryrun", "models.lm",
              "ops.state_update", "utils.hf", "evals", "evals.lm_harness"):
        assert f"fastvim_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "new = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                    'fastvim_tpu', 'PIL', 'sklearn'))\n"
        "assert not new, new\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for m in mods:  # and each is importable here, beside JAX
        importlib.import_module(m)
