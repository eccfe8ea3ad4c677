"""The port stands alone: importing it loads no JAX, flax or JAX package
module, its sources call no library for what its kernels compute, and its
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
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sgformer_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _sources():
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(root, name)) as f:
                    yield os.path.relpath(os.path.join(root, name), REPO), f.read()


def test_sources_use_no_library_for_the_kernels_work():
    banned = re.compile(
        r"^\s*(import|from)\s+(jax|flax|sgformer_tpu)\b"
        r"|torch\.sparse|torch\.matmul|torch\.compile|cublas|cusparse",
        re.MULTILINE | re.IGNORECASE,
    )
    found = [(path, m.group(0).strip()) for path, text in _sources()
             for m in banned.finditer(text)]
    assert not found, found
    modules = {m.name for m in pkgutil.walk_packages(sgformer_tpu_torch.__path__)}
    assert {"kernels", "ops", "nn", "data", "graph", "serve", "convert"} <= modules


def test_kernel_sources_ship_with_the_package():
    csrc = os.path.join(PKG_DIR, "csrc")
    assert sorted(os.listdir(csrc)) == ["linear_attention.cu", "spmm.cu"]


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
    model = SGFormer(cfg, 4, device="cpu")
    graph = preprocess_graph(ei, 3, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model, graph, np.zeros((3, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        graph.to("cuda")
