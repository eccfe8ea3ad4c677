"""The rank side of ``test_torch_dp_batch.py``: what each rank of a gloo
group of 4 CPU processes (dp = 2 x sp = 2) computes with the port's
data-parallel batch trainer, written by each rank to its own file that the
test reads. It imports no JAX, so that a spawned rank loads only torch and
the port."""

import numpy as np
import torch
import torch.distributed as dist

from sgformer_tpu_torch import load_flax_variables
from sgformer_tpu_torch.graph import preprocess_graph
from sgformer_tpu_torch.nn import SGFormer, SGFormerConfig
from sgformer_tpu_torch.parallel import DPBatchTrainer, ShardedTrainer, comm, make_global_mesh
from sgformer_tpu_torch.parallel import make_mesh
from sgformer_tpu_torch.parallel.mesh import axis
from sgformer_tpu_torch.parallel.sharded import average_gradients, sharded_loss
from sgformer_tpu_torch.train import BatchTrainConfig, TrainConfig

torch.set_num_threads(1)

DP, SP = 2, 2
AXES = ("dp", "sp")


def port_model(cfg: dict, f: int, axis_name="sp"):
    return SGFormer(SGFormerConfig(**cfg, axis_name=axis_name), f, device="cpu")


def flax_state(cfg: dict, f: int, variables) -> dict:
    """The port model's state dict holding the flax ``variables``."""
    model = port_model(cfg, f, None)
    load_flax_variables(model, variables)
    return {k: v.clone() for k, v in model.state_dict().items()}


def trainer(problem: dict, mesh, **tc) -> DPBatchTrainer:
    return DPBatchTrainer(port_model(problem["cfg"], problem["x"].shape[1]), problem["edges"],
                          problem["x"], problem["label"], BatchTrainConfig(**tc), mesh=mesh,
                          device="cpu")


def _groups(mesh) -> dict:
    return {ax: dist.get_process_group_ranks(mesh[ax].group) for ax in ("dp", "sp")}


def _collectives(mesh) -> dict:
    """Each axis's all-reduce of (rank + 1), and the calls they counted."""
    comm.calls.clear()
    out = {}
    for ax in ("sp", "dp", AXES):
        t = torch.tensor([float(dist.get_rank() + 1)])
        out[ax] = float(comm.all_reduce_(t, ax))
    return out, dict(comm.calls)


def _rebinds(mesh) -> dict:
    """A second ``make_global_mesh`` of the same layout, and ``make_mesh``
    asked to bind the grid's ``"sp"`` to the whole group: whether the first
    returned the grid it made before, and the error the second raised."""
    out = {"same_grid": make_global_mesh(dp=DP, device="cpu") is mesh, "rebind": ""}
    try:
        make_mesh("sp", device="cpu")
    except ValueError as e:
        out["rebind"] = str(e)
    out["sp_group"] = dist.get_process_group_ranks(axis("sp").group)
    return out


def _one_axis_calls(case: dict) -> dict:
    """One step of a 1-D ShardedTrainer over the whole group, its axis
    named ``"nodes"`` (``"sp"`` is the grid's): its calls."""
    mesh = make_mesh("nodes", device="cpu")
    graph = preprocess_graph(case["edges"], case["n"], device="cpu")
    cfg = SGFormerConfig.large(16, case["cfg"]["out_channels"], trans_num_layers=1,
                               gnn_num_layers=2, trans_dropout=0.0, gnn_dropout=0.0,
                               axis_name="nodes")
    tr = ShardedTrainer(SGFormer(cfg, case["x"].shape[1], device="cpu"), graph, case["x"],
                        case["label"], TrainConfig(lr=1e-3), mesh=mesh, use_halo=False,
                        device="cpu")
    tr.init_state(0)
    mask = tr.prepare_train_idx({"train": np.arange(case["n"])})
    comm.calls.clear()
    tr.train_step(mask)
    return dict(comm.calls)


def _step(step: dict, mesh) -> dict:
    """The dp step on the step case's two batches (every real node trains):
    the loss and gradients, then Adam's parameters and the statistics."""
    tr = trainer(step, mesh, lr=0.01, trans_weight_decay=1e-3, gnn_weight_decay=1e-3,
                 batch_size=len(step["batches"][0]))
    state = flax_state(step["cfg"], step["x"].shape[1], step["variables"])
    tr.init_state(0, state)
    train_set = torch.ones(step["n"], dtype=torch.bool)
    batch = tr.build_batch(torch.from_numpy(step["batches"][mesh.coords[0]]), train_set)
    loss = sharded_loss(tr.model, batch.x, batch.graph, batch.label, batch.node_mask,
                        batch.train_mask, AXES)
    loss.backward()
    average_gradients(tr.model, AXES)
    grads = {k: p.grad.numpy().copy() for k, p in tr.model.named_parameters()}
    tr.init_state(0, state)
    comm.calls.clear()
    stepped = tr.train_step(batch)
    return dict(loss=loss.item(), step_loss=stepped.item(), grads=grads,
                calls=dict(comm.calls),
                state={k: v.numpy().copy() for k, v in tr.model.state_dict().items()})


def _fit(case: dict, mesh, **tc) -> dict:
    tr = trainer(case, mesh, **tc)
    tr.record_losses = True
    state = None
    if "variables" in case:
        state = flax_state(case["cfg"], case["x"].shape[1], case["variables"])
    logger = tr.fit([case["split"]], init_state=state)
    return dict(results=logger.results[0], losses=tr.train_losses,
                steps=tr.num_batches(),
                state={k: v.numpy().copy() for k, v in tr.final_state.items()})


def _refuses_gcn(step: dict, mesh) -> str:
    """The dp step of an SGFormer on the PyG edges (``gnn="gcn"``): the
    error it raises."""
    cfg = dict(step["cfg"], gnn="gcn")
    tr = DPBatchTrainer(port_model(cfg, step["x"].shape[1]), step["edges"], step["x"],
                        step["label"], BatchTrainConfig(batch_size=80), mesh=mesh,
                        device="cpu")
    tr.init_state(0)
    try:
        tr.train_step(tr.build_batch(torch.from_numpy(step["batches"][mesh.coords[0]])))
    except ValueError as e:
        return str(e)
    return ""


def run_ranks(rank: int, case_path: str, out_dir: str) -> None:
    case = torch.load(case_path, weights_only=False)
    res = {"world_rank": rank}
    try:
        make_global_mesh(dp=3, device="cpu")
    except ValueError as e:
        res["dp3"] = str(e)
    mesh = make_global_mesh(dp=DP, device="cpu")
    res.update(coords=mesh.coords, shape=mesh.shape, groups=_groups(mesh))
    res["sums"], res["sum_calls"] = _collectives(mesh)
    res.update(_rebinds(mesh))
    res["step"] = _step(case["step"], mesh)
    res["gcn"] = _refuses_gcn(case["step"], mesh)
    for name, tc in case["fits"].items():
        res[name] = _fit(case[name], mesh, **tc)
    res["one_axis_calls"] = _one_axis_calls(case["step"])
    torch.save(res, f"{out_dir}/rank{rank}.pt")
