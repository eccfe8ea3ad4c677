"""The port stands alone: importing it loads no JAX, flax, optax, orbax,
ml_dtypes, scikit-learn or JAX package module (the machine with the card has none of
them), its sources call no library for what its kernels compute, and its
entry points refuse to run without CUDA unless asked for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import sgformer_tpu_torch
from sgformer_tpu_torch import Predictor, SGFormer, SGFormerConfig, preprocess_graph
from sgformer_tpu_torch.data import synthetic_dataset

torch.set_num_threads(1)

PKG_DIR = os.path.dirname(sgformer_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, sgformer_tpu_torch\n"
        "for m in pkgutil.walk_packages(sgformer_tpu_torch.__path__, 'sgformer_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                                    'ml_dtypes', 'sklearn', 'sgformer_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _sources():
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh", ".cpp")):
                with open(os.path.join(root, name)) as f:
                    yield os.path.relpath(os.path.join(root, name), REPO), f.read()


def test_sources_use_no_library_for_the_kernels_work():
    banned = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|ml_dtypes|sklearn|sgformer_tpu)\b"
        r"|torch\.sparse|torch\.matmul|torch\.compile|cublas|cusparse",
        re.MULTILINE | re.IGNORECASE,
    )
    found = [(path, m.group(0).strip()) for path, text in _sources()
             for m in banned.finditer(text)]
    assert not found, found
    modules = {m.name for m in pkgutil.walk_packages(sgformer_tpu_torch.__path__)}
    assert {"kernels", "ops", "nn", "data", "graph", "serve", "convert", "train",
            "utils", "microbench", "sample", "cli", "native", "parallel"} <= modules


def test_kernel_sources_issue_no_mma_sync():
    """Every tensor-core product of the port runs on warpgroup MMAs: no
    CUDA source under ``csrc/`` issues an ``mma.sync`` instruction. The PTX
    of the ``asm`` strings is searched, the comments (which name the
    designs these kernels replaced) left out."""
    csrc = os.path.join(PKG_DIR, "csrc")
    strings = {}
    for name in sorted(os.listdir(csrc)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, name)) as f:
                code = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read(), flags=re.S)
            strings[name] = re.findall(r'"(?:[^"\\\n]|\\.)*"', code)
    found = [(name, s) for name, found_in in strings.items() for s in found_in
             if "mma.sync" in s]
    assert not found, found
    # the search reads the PTX: the warpgroup MMAs' strings are there
    assert any("wgmma.mma_async" in s for s in strings["tensor_core.cuh"])


def test_kernel_sources_ship_with_the_package(tmp_path, monkeypatch):
    csrc = os.path.join(PKG_DIR, "csrc")
    from sgformer_tpu_torch.kernels import _build

    assert sorted(os.listdir(csrc)) == ["graph_kernels.cpp", "linear_attention.cu",
                                        "linear_attention_bwd.cu", "microbench.cu", "spmm.cu",
                                        "spmm_walk.cuh", "tensor_core.cuh"]
    assert sorted(f"{name}.cu" for name in _build.SOURCES) == sorted(
        f for f in os.listdir(csrc) if f.endswith(".cu"))
    # the sources and the headers they include are package data
    with open(os.path.join(os.path.dirname(PKG_DIR), "pyproject.toml")) as f:
        assert '"csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"' in f.read()
    # an edited header gives the libraries new names, so they are rebuilt
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f), "rb") as src, open(tmp_path / f, "wb") as dst:
            dst.write(src.read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    for header, users in (("tensor_core.cuh", ("linear_attention", "linear_attention_bwd")),
                          ("spmm_walk.cuh", ("spmm", "microbench"))):
        before = [_build._target(name)[1] for name in users]
        with open(tmp_path / header, "a") as f:
            f.write("\n")
        after = [_build._target(name)[1] for name in users]
        assert all(a != b for a, b in zip(after, before))


def test_the_row_walk_has_one_source():
    """The whole warp's CSR row walk is defined in ``spmm_walk.cuh`` alone:
    ``csr_spmm`` (``spmm.cu``) and the ``slab_variant`` probe
    (``microbench.cu``) include it, and neither defines a walk of its own;
    the probe reads no row pointers itself."""
    csrc = os.path.join(PKG_DIR, "csrc")
    code = {}
    for name in sorted(os.listdir(csrc)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, name)) as f:
                code[name] = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read(), flags=re.S)
    walk = r"__device__\s+__forceinline__\s+void\s+(spmm_edges|walk_position)\s*\("
    assert sorted(set(re.findall(walk, code["spmm_walk.cuh"]))) == ["spmm_edges",
                                                                     "walk_position"]
    assert [n for n, c in code.items() if re.search(walk, c)] == ["spmm_walk.cuh"]
    for name in ("spmm.cu", "microbench.cu"):
        assert '#include "spmm_walk.cuh"' in code[name]
    assert "walk_position<Source::kGather" in code["spmm.cu"]
    probe = code["microbench.cu"][code["microbench.cu"].index("slab_variant_kernel("):]
    assert "rw::walk_position<kSrc" in probe
    assert not re.search(r"indptr\s*\[|__shfl_sync", probe)


def test_host_sampler_is_the_ports_own():
    """The sampled tier's C++ sampler is built from the package's own copy
    of its source into the port's build directory: no port source names the
    JAX package's native module or its library, and the loaded library is
    not the JAX package's."""
    from sgformer_tpu_torch.native import build

    found = [path for path, text in _sources()
             if re.search(r"sgformer_tpu[./]native|_graph_kernels\b", text)]
    assert not found, found
    assert build.SOURCE == os.path.join(PKG_DIR, "csrc", "graph_kernels.cpp")
    lib = build.library()
    assert os.path.dirname(lib._name) == build.build_dir()
    assert not lib._name.startswith(os.path.join(REPO, "sgformer_tpu") + os.sep)
    assert os.path.basename(lib._name).startswith("graph_kernels-")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ei = np.array([[0, 1, 2], [1, 2, 0]])
    cfg = SGFormerConfig.large(8, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess_graph(ei, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        SGFormer(cfg, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_dataset(num_nodes=10, num_edges=20)
    from sgformer_tpu_torch.nn import GAT, GCN, MLP

    for make in (lambda: GAT(4, 8, 3), lambda: GCN(4, 8, 3), lambda: MLP(4, 8, 3),
                 lambda: SGFormer(SGFormerConfig.medium(8, 3), 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model = SGFormer(cfg, 4, device="cpu")
    graph = preprocess_graph(ei, 3, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model, graph, np.zeros((3, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        graph.to("cuda")
    from sgformer_tpu_torch.train import (BatchTrainConfig, BatchTrainer, SampledTrainConfig,
                                          SampledTrainer, TrainConfig, Trainer)

    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, graph, np.zeros((3, 4), np.float32), np.zeros((3, 1), np.int64),
                TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchTrainer(model, ei, np.zeros((3, 4), np.float32), np.zeros((3, 1), np.int64),
                     BatchTrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        SampledTrainer(model, ei, np.zeros((3, 4), np.float32), np.zeros((3, 1), np.int64),
                       SampledTrainConfig())
    from sgformer_tpu_torch.parallel import ShardedTrainer, init_distributed, make_mesh

    for make in (lambda: ShardedTrainer(model, graph, np.zeros((3, 4), np.float32),
                                        np.zeros((3, 1), np.int64), TrainConfig()),
                 lambda: make_mesh("sp", device="cuda"),
                 lambda: init_distributed("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_run_group_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``parallel.launch.run_group`` starts its ranks on the card by default:
    without CUDA it raises before it spawns any."""
    from sgformer_tpu_torch.parallel import launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch.mp, "spawn", lambda *a, **k: pytest.fail("a rank was spawned"))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.run_group(print, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.run_group(print, 1, device="cuda", backend="gloo")
