"""Random-partition mini-batch training: a closed loop of epochs, each a
fresh permutation of the nodes drawn on the device from the seed, cut into
batches of ``batch_size`` and a remainder; each batch is
``BatchTrainer.build_batch`` on the card, then ``train_step``. No eval.

Set-up builds one trainer, drives it through epoch 0's first three batches
(checked) and the rest of that epoch (every batch shape the window uses),
and hands that trainer to the window, which starts at epoch 1. The
reference draws the three checked batches' node ids again from the seed,
builds their subgraphs from the raw edges and follows the three steps; the
ids the program's trainer cut for those batches are held to its draw.
"""

from __future__ import annotations

import time

import torch

from portbench import harness as H
from portbench.graphgen import planted_partition
from portbench.references.sgformer import induced_csr, symmetric_edges

CHECKED_STEPS = 3


class State:
    pass


def setup(run: H.Run) -> State:
    from sgformer_tpu_torch.graph import add_self_loops, remove_self_loops, to_undirected
    from sgformer_tpu_torch.train import BatchTrainConfig, BatchTrainer

    s = State()
    inputs = planted_partition(run.graph, run.seed, run.device)
    label = inputs.label.cpu().numpy().reshape(-1, 1)
    n = inputs.num_nodes
    run.phase("inputs on the device")
    # the edge list the port's CLI gives its batch trainer (cli/main.py
    # trainer_edges): symmetrised, one self-loop a node
    edges = add_self_loops(remove_self_loops(to_undirected(inputs.edge_index)), n)
    run.phase("edge list symmetrised on the device")
    model, weights = H.build_model(run)
    cfg = BatchTrainConfig(lr=float(run.train["lr"]),
                           trans_weight_decay=float(run.train["trans_weight_decay"]),
                           gnn_weight_decay=float(run.train["gnn_weight_decay"]),
                           batch_size=int(run.train["batch_size"]), eval_mode="batch")
    trainer = BatchTrainer(model, edges, inputs.x, label, cfg, device=run.device)
    del edges
    trainer.init_state(0)
    model.load_state_dict(weights, strict=True)  # init_state drew others
    model.set_dropout_generator(H.dropout_generator(run))
    s.train_set = torch.zeros(n, dtype=torch.bool, device=run.device)
    s.train_set[inputs.train] = True
    del inputs, label
    run.phase("model, weights and trainer")
    if "trainer" in run.hooks:
        run.hooks["trainer"](trainer)
    s.trainer, s.num_nodes = trainer, n
    s.perms = torch.Generator(device=run.device).manual_seed(run.seed_for(H.SEED_EPOCHS))
    perm = torch.randperm(n, generator=s.perms, device=run.device)
    s.checked = [trainer.batch_nodes(perm, i) for i in range(CHECKED_STEPS)]
    losses = []
    for i, nodes in enumerate(s.checked):
        losses.append(trainer.train_step(trainer.build_batch(nodes, s.train_set)))
        if i == 0:
            grads = H.first_gradients(model, trainer.optimizer)
    s.readings = H.StepReadings([float(v) for v in losses], grads, H.changes(model, weights))
    run.phase(f"{CHECKED_STEPS} checked batches")
    for i in range(CHECKED_STEPS, trainer.num_batches()):
        trainer.train_step(trainer.build_batch(trainer.batch_nodes(perm, i), s.train_set))
    run.phase("warm-up: the rest of epoch 0")
    return s


def _epoch(s: State, timer: H.Timer, steps: list, stop=None) -> int:
    """One epoch's batches, each built and stepped under CUDA events; stops
    early once ``stop()`` holds after a batch. Returns its non-finite
    losses."""
    t = s.trainer
    perm = torch.randperm(s.num_nodes, generator=s.perms, device=s.train_set.device)
    losses = []
    for i in range(t.num_batches()):
        a = timer.mark()
        with H.span("build_batch"):
            batch = t.build_batch(t.batch_nodes(perm, i), s.train_set)
        b = timer.mark()
        with H.span("train_step"):
            losses.append(t.train_step(batch))
        steps.append({"nodes": int(batch.node_idx.numel()), "edges": batch.graph.num_edges,
                      "marks": (a, b, timer.mark())})
        del batch
        if stop is not None and stop():
            break
    with H.span("loss_sync"):
        host = torch.stack(losses).cpu()
    return int((~torch.isfinite(host)).sum())


def _finish(steps: list, timer: H.Timer) -> None:
    for st in steps:
        a, b, c = st.pop("marks")
        st["build_ms"] = timer.ms(a, b)
        st["ms"] = timer.ms(a, c)


def window(run: H.Run, s: State) -> H.Window:
    timer = H.Timer(run.device)
    steps, failed = [], 0
    run.window_starts()
    t0 = time.perf_counter()

    def over():
        return time.perf_counter() - t0 >= run.seconds

    while not over():
        failed += _epoch(s, timer, steps, over)
    run.sync()
    secs = time.perf_counter() - t0
    _finish(steps, timer)
    return H.Window(secs, steps, [], len(steps), failed)


def traced(run: H.Run, s: State) -> tuple[list, int]:
    """The traced work: ``trace_epochs`` more epochs."""
    timer = H.Timer(run.device)
    steps, failed = [], 0
    for _ in range(int(run.traffic["trace_epochs"])):
        failed += _epoch(s, timer, steps)
    run.sync()
    _finish(steps, timer)
    return [{"kind": "train", "nodes": st["nodes"], "edges": st["edges"]} for st in steps], failed


def release(run: H.Run, s: State) -> dict:
    kept = {"readings": s.readings, "checked": [c.clone() for c in s.checked]}
    s.trainer = s.train_set = s.checked = None
    return kept


def reference_batches(run: H.Run, n: int) -> list:
    """The checked batches' node ids, drawn again from the seed: epoch 0's
    permutation, cut into batches of ``batch_size``."""
    gen = torch.Generator(device=run.device).manual_seed(run.seed_for(H.SEED_EPOCHS))
    perm = torch.randperm(n, generator=gen, device=run.device)
    b = int(run.train["batch_size"])
    return [perm[i * b:(i + 1) * b] for i in range(CHECKED_STEPS)]


def batches_differ(program: list, reference: list) -> int:
    """The checked batches whose node ids the program cut otherwise than
    the reference drew them."""
    return sum(not (a.shape == b.shape and bool((a.to(b.device) == b).all()))
               for a, b in zip(program, reference)) + abs(len(program) - len(reference))


def reference_inputs(run: H.Run, checked=None) -> list:
    """The reference's three steps' inputs, made again from the seed: the
    checked batches' subgraphs built from the raw edges (``checked``: their
    node ids, by default :func:`reference_batches`)."""
    inputs = planted_partition(run.graph, run.seed, run.device)
    n = inputs.num_nodes
    if checked is None:
        checked = reference_batches(run, n)
    src, dst = symmetric_edges(inputs.edge_index, n)
    in_train = torch.zeros(n, device=run.device)
    in_train[inputs.train] = 1.0
    steps = []
    for nodes in checked:
        mask = in_train[nodes]
        steps.append((inputs.x[nodes], induced_csr(src, dst, nodes, n), inputs.label[nodes], mask,
                      mask.sum().clamp(min=1.0)))
    return steps


def check(run: H.Run, kept: dict) -> tuple[dict, dict]:
    """The numbers of the program's readings against the reference's; and
    what to print beside them."""
    from portbench.references.sgformer import draw_weights

    checked = reference_batches(run, int(run.graph["num_nodes"]))
    steps = reference_inputs(run, checked)
    weights = draw_weights(run.model, run.in_channels, run.seed_for(H.SEED_WEIGHTS), run.device)
    ref = H.reference_steps(run, weights, steps, "f32")
    numbers, left_out = H.compare_steps(kept["readings"], ref)
    numbers["batches_differ"] = batches_differ(kept["checked"], checked)
    return numbers, {"left_out": left_out, "ref_losses": ref.losses,
                     "losses": kept["readings"].losses}
