"""The JAX package's inventory (``test_inventory.COMPONENTS``), mapped onto
the port and machine-checked: every public name of the JAX package exists in
``sgformer_tpu_torch`` at the same module path, except the names that have
no port by design, each listed with the port's counterpart that does its
work."""

import importlib

import pytest

from test_inventory import COMPONENTS

# (JAX module, name) -> (port module, counterpart): the TPU layout plans of
# the chunked MXU SpMM; the port's CSR SpMM kernels do their work
BY_DESIGN = {
    ("sgformer_tpu.kernels", "chunked_spmm"): ("sgformer_tpu_torch.kernels.spmm", "csr_spmm"),
    ("sgformer_tpu.kernels.spmm", "chunked_spmm_edge_values"):
        ("sgformer_tpu_torch.kernels.spmm", "csr_spmm_ev"),
}


def _port(module: str) -> str:
    return "sgformer_tpu_torch" + module[len("sgformer_tpu"):]


@pytest.mark.parametrize("module,name", COMPONENTS, ids=[f"{m}.{n}" for m, n in COMPONENTS])
def test_component_exists_in_the_port(module, name):
    module, name = BY_DESIGN.get((module, name), (_port(module), name))
    assert hasattr(importlib.import_module(module), name), f"{module}.{name} missing"


@pytest.mark.parametrize("key", sorted(BY_DESIGN), ids=lambda k: f"{k[0]}.{k[1]}")
def test_names_without_a_port_are_absent(key):
    """The by-design table lists only names that the port lacks."""
    module, name = key
    assert not hasattr(importlib.import_module(_port(module)), name)
