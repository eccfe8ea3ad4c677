"""The port's scaling harness (``sgformer_tpu_torch.parallel.scaling``) on
CPU ranks under gloo: the JAX harness's flags and JSON keys (CPU times mean
nothing)."""

import json

import pytest
import torch


def test_scaling_harness_prints_the_jax_keys(capsys):
    """``parallel.scaling`` on CPU ranks under gloo: one group a device
    count, the JAX harness's JSON keys, the efficiency line; more NCCL ranks
    than cards are refused."""
    from sgformer_tpu_torch.parallel import scaling

    res = scaling.main(["--devices", "1", "2", "--nodes", "300", "--edges", "1200",
                        "--hidden", "16", "--platform", "cpu", "--halo", "--reorder"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    keys = {"devices", "step_ms", "edges_per_sec", "edges_per_sec_per_device"}
    assert [set(r) for r in res] == [keys, keys] and lines[:2] == res
    assert [r["devices"] for r in res] == [1, 2] and all(r["step_ms"] > 0 for r in res)
    assert set(lines[2]) == {"devices", "scaling_efficiency"}
    with pytest.raises(ValueError, match="cards under NCCL"):
        scaling.measure(torch.cuda.device_count() + 1, 300, 1200, 16, device="cuda")
