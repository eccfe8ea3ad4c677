"""The rank side of ``test_torch_parallel.py``: what each rank of a gloo group
of CPU processes computes with the port's node-sharded trainer, written by
rank 0 to a file that the test reads. It imports no JAX, so that a spawned
rank loads only torch and the port."""

import numpy as np
import torch
import torch.distributed as dist

from sgformer_tpu_torch import load_flax_variables
from sgformer_tpu_torch.graph import preprocess_graph
from sgformer_tpu_torch.kernels.attention import fused_linear_attention
from sgformer_tpu_torch.nn import (APPNP, GCNJK, GPRGNN, SGC, SGC2, SIGN, MixHop, SGFormer,
                                   SGFormerConfig)
from sgformer_tpu_torch.ops.attention import linear_attention
from sgformer_tpu_torch.parallel import ShardedTrainer, make_mesh
from sgformer_tpu_torch.parallel.sharded import average_gradients
from sgformer_tpu_torch.train import TrainConfig, Trainer

torch.set_num_threads(1)

STEP_CASES = [(gnn, halo) for gnn in ("graphconv", "gcn") for halo in (False, True)]
# the baselines the sharded CLI also builds, each with the halo and without
BASELINES = ("sgc", "sgc2", "sign", "mixhop", "gcnjk", "appnp", "gprgnn")
BASELINE_CASES = [(m, halo) for m in BASELINES for halo in (False, True)]


def baseline_model(case: dict, method: str, axis_name=None):
    """One of :data:`BASELINES` at the case's widths, dropout 0; the
    modules with BatchNorm take ``axis_name``."""
    f, hidden, c = case["x"].shape[1], case["hidden"], case["classes"]
    bn = dict(dropout=0.0, axis_name=axis_name, device="cpu")
    if method == "sgc":
        return SGC(f, c, hops=2, device="cpu")
    if method == "sgc2":
        return SGC2(f, hidden, c, hops=2, **bn)
    if method == "sign":
        return SIGN(f, hidden, c, hops=2, num_layers=3, **bn)
    if method == "mixhop":
        return MixHop(f, hidden, c, hops=2, **bn)
    if method == "gcnjk":
        return GCNJK(f, hidden, c, num_layers=3, **bn)
    if method == "appnp":
        return APPNP(f, hidden, c, dropout=0.0, device="cpu")
    return GPRGNN(f, hidden, c, dropout=0.0, dprate=0.0, device="cpu")


def baseline_step(case: dict, method: str, halo=None, mesh=None) -> dict:
    """A baseline's eval logits, loss and gradients from ``init_state(0)``:
    on this rank's shard with ``mesh`` (gradients averaged), else on the
    one-device ``Trainer``."""
    graph = preprocess_graph(case["edge_index"], case["n"], with_pyg_norm=True, device="cpu")
    if mesh is None:
        tr = Trainer(baseline_model(case, method), graph, case["x"], case["label"],
                     TrainConfig(lr=1e-3), device="cpu")
    else:
        tr = ShardedTrainer(baseline_model(case, method, "sp"), graph, case["x"],
                            case["label"], TrainConfig(lr=1e-3), mesh=mesh, use_halo=halo,
                            device="cpu")
    tr.init_state(0)
    logits = tr.eval_step()
    loss = tr.loss(tr.prepare_train_idx({"train": case["train_idx"]}))
    loss.backward()
    if mesh is not None:
        average_gradients(tr.model, "sp")
    return dict(logits=logits.numpy(), loss=float(loss),
                grads={k: p.grad.numpy().copy() for k, p in tr.model.named_parameters()})


def port_model(case: dict, gnn: str, axis_name=None):
    cfg = SGFormerConfig.large(case["hidden"], case["classes"], gnn=gnn, axis_name=axis_name,
                               **case["cfg"])
    return SGFormer(cfg, case["x"].shape[1], device="cpu")


def sharded_trainer(case: dict, gnn: str, halo: bool, tc=None, reorder=False, mesh=None):
    """A ShardedTrainer on this rank with the case's flax variables."""
    graph = preprocess_graph(case["edge_index"], case["n"], with_pyg_norm=True, reorder=reorder,
                             device="cpu")
    tr = ShardedTrainer(port_model(case, gnn, "sp"), graph, case["x"], case["label"],
                        tc or TrainConfig(lr=1e-3), mesh=mesh, use_halo=halo, device="cpu")
    init = tr.init_state

    def init_state(seed):
        optimizer = init(seed)
        load_flax_variables(tr.model, case["variables"][gnn])
        return optimizer

    tr.init_state = init_state
    tr.init_state(0)
    return tr


def _gather_rows(t: torch.Tensor, n: int) -> np.ndarray:
    t = t.detach().contiguous()
    out = t.new_empty((dist.get_world_size() * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t)
    return out[:n].numpy()


def _attention(case: dict, rank: int, size: int) -> dict:
    """Each attention path on this rank's rows of the case's q, k, v, with
    a cotangent g: the rows of the output and of dq, dk, dv, gathered."""
    n = case["n"]
    block = -(-n // size)
    lo, hi = min(rank * block, n), min((rank + 1) * block, n)
    out = {}
    for name, fn in (("kernel", fused_linear_attention), ("plain", linear_attention)):
        ts = []
        for key in ("q", "k", "v", "g"):
            full = torch.from_numpy(case["attn"][key])
            local = torch.zeros((block,) + tuple(full.shape[1:]))
            local[:hi - lo] = full[lo:hi]
            ts.append(local.requires_grad_(key != "g"))
        mask = torch.zeros(block)
        mask[:hi - lo] = 1.0
        q, k, v, g = ts
        o = fn(q, k, v, node_mask=mask, axis_name="sp")
        o.backward(g)
        out[name] = [_gather_rows(t, n) for t in (o, q.grad, k.grad, v.grad)]
    return out


def run_ranks(rank: int, case_path: str, out_path: str) -> None:
    case = torch.load(case_path, weights_only=False)
    mesh = make_mesh("sp")
    res = {}
    train = {"train": case["train_idx"]}
    for gnn, halo in STEP_CASES:
        tr = sharded_trainer(case, gnn, halo, mesh=mesh)
        logits = tr.eval_step()
        again = tr.eval_step()
        mask = tr.prepare_train_idx(train)
        loss = tr.loss(mask)
        loss.backward()
        average_gradients(tr.model, "sp")
        res[("step", gnn, halo)] = dict(
            logits=logits.numpy(), repeat=bool(torch.equal(logits, again)),
            loss=float(loss), halo_rows=tr.graph.halo_rows,
            grads={k: p.grad.numpy().copy() for k, p in tr.model.named_parameters()},
            buffers={k: b.numpy().copy() for k, b in tr.model.named_buffers()})
    for method, halo in BASELINE_CASES:
        res[("baseline", method, halo)] = baseline_step(case, method, halo, mesh)
    res["attention"] = _attention(case, rank, mesh.size)

    # fit: five Adam steps, an eval after each
    tc = TrainConfig(lr=1e-3, epochs=5, eval_step=1, display_step=-1,
                     trans_weight_decay=1e-3, gnn_weight_decay=5e-4)
    tr = sharded_trainer(case, "graphconv", True, tc, mesh=mesh)
    res["fit"] = tr.fit([case["splits"]]).results[0]

    # multi_step(k) against k train_steps
    tr = sharded_trainer(case, "graphconv", True, tc, mesh=mesh)
    mask = tr.prepare_train_idx(train)
    blocked = tr.multi_step(mask, 3)
    blocked_state = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.init_state(0)
    single = torch.stack([tr.train_step(mask) for _ in range(3)])
    res["multi_step"] = dict(
        blocked=blocked.numpy(), single=single.numpy(),
        same_state=all(torch.equal(v, tr.model.state_dict()[k])
                       for k, v in blocked_state.items()))

    # the reordered graph: eval logits in the caller's order, then training
    for halo in (False, True):
        tr = sharded_trainer(case, "graphconv", halo, reorder=True, mesh=mesh)
        res[("reorder", halo)] = dict(logits=tr.eval_step().numpy(),
                                      halo_rows=tr.graph.halo_rows)
    tc = TrainConfig(lr=0.01, epochs=30, eval_step=5, display_step=-1)
    graph = preprocess_graph(case["learn"]["edge_index"], case["learn"]["n"], reorder=True,
                             device="cpu")
    learn = case["learn"]
    cfg = SGFormerConfig(32, learn["classes"], gnn="graphconv", axis_name="sp",
                         trans_dropout=0.1, gnn_dropout=0.1)
    tr = ShardedTrainer(SGFormer(cfg, learn["x"].shape[1], device="cpu"), graph, learn["x"],
                        learn["label"], tc, mesh=mesh, device="cpu")
    logger = tr.fit([learn["split"]])
    res["reorder_learns"] = logger.run_summary(0)["final_test"]
    if rank == 0:
        torch.save(res, out_path)
