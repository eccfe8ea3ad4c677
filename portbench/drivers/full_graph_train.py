"""Full-graph training: a closed loop of ``Trainer.train_step`` calls in
blocks of ``block_steps`` (the recipe's ``eval_step``, as ``Trainer.fit``
blocks them), one sync and a finite-loss check a block.

Set-up builds one trainer, drives it from the seed through three checked
steps and the rest of a block, and hands that trainer to the window. The
reference follows the three checked steps from the same weights, inputs
and dropout masks.
"""

from __future__ import annotations

import time

import torch

from portbench import harness as H
from portbench.graphgen import planted_partition
from portbench.references.sgformer import gcn_csr, symmetric_edges

CHECKED_STEPS = 3


class State:
    pass


def setup(run: H.Run) -> State:
    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.train import TrainConfig, Trainer

    s = State()
    inputs = planted_partition(run.graph, run.seed, run.device)
    label = inputs.label.cpu().numpy().reshape(-1, 1)
    train_ids = inputs.train.cpu().numpy()
    run.phase("inputs on the device")
    graph = preprocess_graph(inputs.edge_index, inputs.num_nodes, device=run.device)
    run.phase("preprocess_graph (walk order on the host)")
    model, weights = H.build_model(run)
    cfg = TrainConfig(lr=float(run.train["lr"]),
                      trans_weight_decay=float(run.train["trans_weight_decay"]),
                      gnn_weight_decay=float(run.train["gnn_weight_decay"]))
    trainer = Trainer(model, graph, inputs.x, label, cfg, device=run.device)
    trainer.init_state(0)
    model.load_state_dict(weights, strict=True)  # init_state drew others
    model.set_dropout_generator(H.dropout_generator(run))
    s.train_idx = trainer.prepare_train_idx({"train": train_ids})
    del inputs, label
    run.phase("model, weights and trainer")
    if "trainer" in run.hooks:
        run.hooks["trainer"](trainer)
    s.trainer, s.nodes, s.edges = trainer, graph.num_nodes, graph.num_edges
    s.block = int(run.traffic["block_steps"])
    losses = []
    for i in range(CHECKED_STEPS):
        losses.append(trainer.train_step(s.train_idx))
        if i == 0:
            grads = H.first_gradients(model, trainer.optimizer)
    s.readings = H.StepReadings([float(v) for v in losses], grads, H.changes(model, weights))
    run.phase(f"{CHECKED_STEPS} checked steps")
    for _ in range(max(0, s.block - CHECKED_STEPS)):
        trainer.train_step(s.train_idx)
    run.phase("warm-up to the end of a block")
    return s


def _block(s: State, timer: H.Timer, steps: list) -> int:
    """One block: its steps timed, then one sync; returns its non-finite
    losses."""
    marks, losses = [], []
    for _ in range(s.block):
        a = timer.mark()
        with H.span("train_step"):
            losses.append(s.trainer.train_step(s.train_idx))
        marks.append((a, timer.mark()))
    with H.span("block_sync"):
        host = torch.stack(losses).cpu()
    steps.extend({"nodes": s.nodes, "edges": s.edges, "marks": m} for m in marks)
    return int((~torch.isfinite(host)).sum())


def _finish(steps: list, timer: H.Timer) -> None:
    for st in steps:
        a, b = st.pop("marks")
        st["ms"] = timer.ms(a, b)


def window(run: H.Run, s: State) -> H.Window:
    timer = H.Timer(run.device)
    steps, failed = [], 0
    run.window_starts()
    t0 = time.perf_counter()
    while True:
        failed += _block(s, timer, steps)
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    secs = time.perf_counter() - t0
    _finish(steps, timer)
    return H.Window(secs, steps, [], len(steps), failed)


def traced(run: H.Run, s: State) -> tuple[list, int]:
    """The traced work: ``trace_blocks`` more blocks."""
    timer = H.Timer(run.device)
    steps, failed = [], 0
    for _ in range(int(run.traffic["trace_blocks"])):
        failed += _block(s, timer, steps)
    run.sync()
    _finish(steps, timer)
    return [{"kind": "train", "nodes": st["nodes"], "edges": st["edges"]} for st in steps], failed


def release(run: H.Run, s: State) -> dict:
    readings = s.readings
    s.trainer = s.train_idx = None
    return {"readings": readings}


def reference_inputs(run: H.Run):
    """The reference's three steps' inputs, made again from the seed."""
    inputs = planted_partition(run.graph, run.seed, run.device)
    n = inputs.num_nodes
    csr = gcn_csr(*symmetric_edges(inputs.edge_index, n), n)
    mask = torch.zeros(n, device=run.device)
    mask[inputs.train] = 1.0
    step = (inputs.x, csr, inputs.label, mask, float(inputs.train.numel()))
    return [step] * CHECKED_STEPS


def check(run: H.Run, kept: dict) -> tuple[dict, dict]:
    """The numbers of the program's readings against the reference's; and
    what to print beside them."""
    from portbench.references.sgformer import draw_weights

    weights = draw_weights(run.model, run.in_channels, run.seed_for(H.SEED_WEIGHTS), run.device)
    ref = H.reference_steps(run, weights, reference_inputs(run), "f32")
    numbers, left_out = H.compare_steps(kept["readings"], ref)
    return numbers, {"left_out": left_out, "ref_losses": ref.losses,
                     "losses": kept["readings"].losses}
