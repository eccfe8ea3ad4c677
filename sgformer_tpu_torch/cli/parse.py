"""The CLI's flag set and model factory: the port of
``sgformer_tpu/cli/parse.py``.

The flags are the JAX CLI's, one for one, plus ``--device`` (default
``cuda``; the CLI raises without a card unless it is ``cpu``). The TPU
layout flags (``--use_pallas``, ``--spmm_mode``, ``--hub_rows``,
``--slab_dtype auto``, ``--attention_impl``) are accepted so that the
recipes run unchanged; ``cli/main.py`` says what each maps to.
:func:`parse_method` builds the port's modules, each with an explicit
``in_channels``, a CPU generator seeded ``--seed`` and the device: every
``--method`` and ``--attention`` of the JAX CLI. Under ``--trainer sharded``
the model gets ``axis_name="sp"``, as the JAX CLI's does; the port's
node-sharded trainer runs SGFormer (the simple attention) and the baselines
whose aggregations the shard graph has (:data:`SHARDED_METHODS`), and
refuses the other methods (GAT and its kin in the JAX package too).
"""

from __future__ import annotations

import argparse

import torch


def parser_add_main_args(parser: argparse.ArgumentParser):
    # experiment
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the model trains: 'cuda' (default; "
                             "raises without a card) or 'cpu'")
    parser.add_argument("--dataset", type=str, default="cora")
    parser.add_argument("--sub_dataset", type=str, default="")
    parser.add_argument("--data_dir", type=str, default="data/")
    parser.add_argument("--method", type=str, default="sgformer")
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument("--runs", type=int, default=1)
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--eval_step", type=int, default=1)
    parser.add_argument("--display_step", type=int, default=50)
    parser.add_argument("--patience", type=int, default=0)
    parser.add_argument("--metric", type=str, default="acc",
                        choices=["acc", "rocauc", "f1"])
    parser.add_argument("--model_selection", type=str, default="max_acc",
                        choices=["max_acc", "min_loss"])
    # splits
    parser.add_argument("--rand_split", action="store_true")
    parser.add_argument("--rand_split_class", action="store_true")
    parser.add_argument("--label_num_per_class", type=int, default=20)
    parser.add_argument("--valid_num", type=int, default=500)
    parser.add_argument("--test_num", type=int, default=1000)
    parser.add_argument("--train_prop", type=float, default=0.5)
    parser.add_argument("--valid_prop", type=float, default=0.25)
    parser.add_argument("--no_feat_norm", action="store_true")
    parser.add_argument("--lamda", type=float, default=1.0,
                        help="NodeFormer edge-regularization weight")
    # optimization
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--weight_decay", type=float, default=5e-3)
    parser.add_argument("--trans_weight_decay", type=float, default=1e-3)
    parser.add_argument("--gnn_weight_decay", type=float, default=1e-3)
    # shared model shape
    parser.add_argument("--hidden_channels", type=int, default=32)
    parser.add_argument("--num_layers", type=int, default=2)
    parser.add_argument("--num_heads", type=int, default=1)
    parser.add_argument("--gat_heads", type=int, default=None,
                        help="GAT hidden-layer heads (large/parse.py:122; "
                             "falls back to --num_heads)")
    parser.add_argument("--out_heads", type=int, default=1,
                        help="GAT output-layer heads (large/parse.py:124)")
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--hops", type=int, default=2)
    parser.add_argument("--use_bn", action="store_true")
    parser.add_argument("--no_bn", action="store_true")
    # sgformer attention branch (large/parse.py:84-102)
    parser.add_argument("--trans_num_layers", type=int, default=1)
    parser.add_argument("--trans_num_heads", type=int, default=1)
    parser.add_argument("--trans_dropout", type=float, default=0.5)
    parser.add_argument("--trans_use_bn", action="store_true", default=True)
    parser.add_argument("--trans_use_residual", action="store_true", default=True)
    parser.add_argument("--trans_use_weight", action="store_true", default=True)
    parser.add_argument("--trans_use_act", action="store_true", default=False)
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--trans_residual_mode", type=str, default="alpha",
                        choices=["alpha", "mean"],
                        help="attention-stack residual: 'alpha' = "
                             "alpha*x+(1-alpha)*prev (medium/ours.py:152, "
                             "100M/ours.py:264); 'mean' = (x+prev)/2 "
                             "(large/ours.py:211).  Identical when "
                             "alpha=0.5; pass 'mean' to pin large-tier "
                             "semantics independently of --alpha")
    parser.add_argument("--attention", type=str, default="simple",
                        choices=["simple", "softmax", "gat", "performer"])
    parser.add_argument("--attention_impl", type=str, default="auto",
                        choices=["auto", "xla", "pallas"],
                        help="the JAX package's attention route; every "
                             "value runs the port's one route per device")
    parser.add_argument("--compute_dtype", type=str, default="f32",
                        choices=["f32", "bf16"])
    # sgformer gnn branch (large/parse.py:104-118)
    parser.add_argument("--use_graph", action="store_true", default=True)
    parser.add_argument("--no_graph", action="store_true")
    parser.add_argument("--gnn_num_layers", type=int, default=2)
    parser.add_argument("--gnn_dropout", type=float, default=0.5)
    parser.add_argument("--gnn_use_bn", action="store_true", default=True)
    parser.add_argument("--gnn_use_residual", action="store_true", default=True)
    parser.add_argument("--gnn_use_weight", action="store_true", default=True)
    parser.add_argument("--gnn_use_init", action="store_true", default=False)
    parser.add_argument("--gnn_use_act", action="store_true", default=True)
    parser.add_argument("--backbone", type=str, default="gcn",
                        choices=["gcn", "graphconv"])
    parser.add_argument("--graph_weight", type=float, default=0.8)
    parser.add_argument("--aggregate", type=str, default="add",
                        choices=["add", "cat"])
    # execution mode
    parser.add_argument("--trainer", type=str, default="full",
                        choices=["full", "sharded", "batch", "sampled"])
    parser.add_argument("--batch_size", type=int, default=10000)
    parser.add_argument("--fanouts", type=int, nargs="+", default=[15, 10, 5])
    parser.add_argument("--no_undirected", action="store_true",
                        help="skip to_undirected (deezer/proteins semantics)")
    # the JAX CLI's TPU layout flags: accepted so that its recipes run
    # unchanged; cli/main.py maps each (most are ignored with one note)
    parser.add_argument("--use_pallas", action="store_true", default=False,
                        help="TPU chunk plans; ignored by the port (the CSR "
                             "kernels run on the card whatever it says)")
    parser.add_argument("--use_halo", action="store_true", default=False,
                        help="sharded trainer: exchange only the boundary "
                             "rows (all-to-all) instead of all-gathering "
                             "the activation")
    parser.add_argument("--chunk_dtype", type=str, default="bf16",
                        choices=["bf16", "f32"],
                        help="TPU chunk plans' message type; the port's GAT "
                             "messages stay f32, as the JAX CLI's are "
                             "(cli/main.py)")
    parser.add_argument("--spmm_mode", type=str, default="chunks",
                        choices=["chunks", "slab", "ssel"],
                        help="TPU SpMM layout; ignored by the port")
    parser.add_argument("--hub_rows", type=int, default=0,
                        help="TPU VMEM hub tail; ignored by the port (its "
                             "CSR kernels split hub rows themselves)")
    parser.add_argument("--slab_dtype", type=str, default=None,
                        choices=["auto", "bf16", "int8"],
                        help="aggregation type: 'int8' the int8 kernel "
                             "(bf16 messages), 'bf16' and 'auto' x's own "
                             "type (the port has no VMEM policy)")
    parser.add_argument("--slab_int8", action="store_true",
                        help="the int8 aggregation (absmax-quantised rows, "
                             "exact int32 sums); perturbs activations and "
                             "gradients")
    # checkpointing (100M/parse.py flags)
    parser.add_argument("--save_model", action="store_true")
    parser.add_argument("--use_pretrained", action="store_true")
    parser.add_argument("--model_dir", type=str, default="models/ckpt")
    parser.add_argument("--eval_train", action="store_true",
                        help="sampled trainer: also sweep the TRAIN split "
                             "each eval epoch (the reference's 100M loop "
                             "sweeps only valid/test, nb-sample.py:176-191;"
                             " a papers100M train sweep is ~10x the "
                             "valid+test work)")
    parser.add_argument("--transfer_dtype", type=str, default="auto",
                        choices=["auto", "bf16", "f32"],
                        help="sampled trainer: dtype of the per-batch "
                             "feature buffer shipped host->device ('auto' "
                             "= bf16 on the bf16 compute path — identical "
                             "numerics, half the transfer)")
    parser.add_argument("--sampler_workers", type=int, default=0,
                        help="sampled trainer: concurrent sampling "
                             "threads (the C++ sampler releases the GIL; "
                             "the reference hardcodes num_workers=12); 0 "
                             "samples in the prefetch thread")
    # outputs
    parser.add_argument("--time_test", action="store_true",
                        help="timing/memory benchmark instead of training "
                             "(medium/time_test.py equivalent)")
    parser.add_argument("--trace_dir", type=str, default=None,
                        help="write a torch.profiler trace during --time_test")
    parser.add_argument("--save_result", action="store_true")
    parser.add_argument("--result_dir", type=str, default="results/")
    # attention-map dump (medium/ours.py:162-177 get_attentions; the
    # reference implements the method but never plumbs it to a CLI)
    parser.add_argument("--save_attn", action="store_true",
                        help="dump [L,N,N] attention maps after training"
                             " (small graphs only)")
    parser.add_argument("--attn_dir", type=str, default="results/attn/")
    return parser


# the methods the node-sharded trainer runs, as the JAX CLI builds them under
# --trainer sharded: the modules with BatchNorm take axis_name, and every
# aggregation is the shard graph's propagate
SHARDED_METHODS = ("sgformer", "ours", "mlp", "gcn", "sgc", "sgc2", "sign", "mixhop", "gcnjk",
                   "appnp", "gprgnn")


def parse_method(args, n: int, c: int, d: int):
    """Model factory (reference: ``large/parse.py:4-42``) for ``n`` nodes,
    ``c`` classes and ``d`` input features. Returns a model of the port
    with the trainers' ``forward(x, graph, node_mask=None)`` contract, its
    parameters drawn from a CPU generator seeded ``args.seed``, on
    ``args.device``."""
    from sgformer_tpu_torch.nn import (
        APPNP,
        DIFFormer,
        GAT,
        GATJK,
        GCN,
        GCNJK,
        GPRGNN,
        H2GCN,
        LINK,
        MLP,
        SGC,
        SGC2,
        SIGN,
        GraphGPS,
        Graphormer,
        GraphTrans,
        MixHop,
        NodeFormer,
        SGFormer,
        SGFormerConfig,
    )

    method = args.method
    axis = "sp" if args.trainer == "sharded" else None
    if axis is not None and method not in SHARDED_METHODS:
        raise ValueError(f"--trainer sharded runs --method {', '.join(SHARDED_METHODS)}, "
                         f"not {method}")
    use_bn = not args.no_bn
    port = dict(generator=torch.Generator().manual_seed(args.seed), device=args.device)
    if method in ("sgformer", "ours"):
        cfg = SGFormerConfig(
            hidden_channels=args.hidden_channels,
            out_channels=c,
            trans_num_layers=args.trans_num_layers,
            trans_num_heads=args.trans_num_heads,
            trans_dropout=args.trans_dropout,
            trans_use_bn=args.trans_use_bn,
            trans_use_residual=args.trans_use_residual,
            trans_use_weight=args.trans_use_weight,
            trans_use_act=args.trans_use_act,
            trans_residual_mode=args.trans_residual_mode,
            attention_kernel=args.attention,
            attention_impl=args.attention_impl,
            compute_dtype=args.compute_dtype,
            alpha=args.alpha,
            gnn="none" if args.no_graph else args.backbone,
            gnn_num_layers=args.gnn_num_layers,
            gnn_dropout=args.gnn_dropout,
            gnn_use_bn=args.gnn_use_bn,
            gnn_use_residual=args.gnn_use_residual,
            gnn_use_weight=args.gnn_use_weight,
            gnn_use_init=args.gnn_use_init,
            gnn_use_act=args.gnn_use_act,
            graph_weight=args.graph_weight,
            aggregate=args.aggregate,
            axis_name=axis,
        )
        return SGFormer(cfg, d, **port)
    if method == "mlp":
        return MLP(d, args.hidden_channels, c, num_layers=args.num_layers,
                   dropout=args.dropout, use_bn=use_bn, axis_name=axis, **port)
    if method == "gcn":
        return GCN(d, args.hidden_channels, c, num_layers=args.num_layers,
                   dropout=args.dropout, use_bn=use_bn, axis_name=axis, **port)
    if method == "gat":
        return GAT(d, args.hidden_channels, c, num_layers=args.num_layers,
                   heads=args.gat_heads or args.num_heads, out_heads=args.out_heads,
                   dropout=args.dropout, use_bn=use_bn, **port)
    if method == "sgc":
        return SGC(d, c, hops=args.hops, **port)
    if method == "sgc2":
        return SGC2(d, args.hidden_channels, c, hops=args.hops, num_layers=args.num_layers,
                    dropout=args.dropout, use_bn=use_bn, axis_name=axis, **port)
    if method == "sign":
        return SIGN(d, args.hidden_channels, c, hops=args.hops, num_layers=args.num_layers,
                    dropout=args.dropout, use_bn=use_bn, axis_name=axis, **port)
    if method == "mixhop":
        return MixHop(d, args.hidden_channels, c, num_layers=args.num_layers, hops=args.hops,
                      dropout=args.dropout, use_bn=use_bn, axis_name=axis, **port)
    if method == "gcnjk":
        return GCNJK(d, args.hidden_channels, c, num_layers=args.num_layers,
                     dropout=args.dropout, use_bn=use_bn, axis_name=axis, **port)
    if method == "gatjk":
        return GATJK(d, args.hidden_channels, c, num_layers=args.num_layers,
                     heads=args.gat_heads or args.num_heads, dropout=args.dropout,
                     use_bn=use_bn, **port)
    if method == "appnp":
        return APPNP(d, args.hidden_channels, c, dropout=args.dropout, **port)
    if method == "gprgnn":
        return GPRGNN(d, args.hidden_channels, c, dropout=args.dropout, **port)
    if method == "link":
        return LINK(n, c, **port)
    if method == "difformer":
        return DIFFormer(d, args.hidden_channels, c, num_layers=args.num_layers,
                         num_heads=args.num_heads, alpha=args.alpha, dropout=args.dropout,
                         use_bn=use_bn, **port)
    if method == "nodeformer":
        return NodeFormer(d, args.hidden_channels, c, num_layers=args.num_layers,
                          num_heads=args.num_heads, dropout=args.dropout, use_bn=use_bn,
                          rb_order=2, **port)
    if method == "graphtrans":
        return GraphTrans(d, args.hidden_channels, c, num_layers=args.num_layers,
                          dropout=args.dropout, use_bn=use_bn, **port)
    if method == "graphgps":
        return GraphGPS(d, args.hidden_channels, c, num_layers=args.num_layers,
                        num_heads=max(args.num_heads, 1), dropout=args.dropout,
                        use_bn=use_bn, **port)
    if method == "graphormer":
        return Graphormer(d, c, embed_dim=args.hidden_channels, num_layers=args.num_layers,
                          num_heads=max(args.num_heads, 1), dropout=args.dropout,
                          attn_dropout=args.dropout, **port)
    if method == "h2gcn":
        return H2GCN(d, args.hidden_channels, c, num_layers=args.num_layers,
                     dropout=args.dropout, **port)
    raise ValueError(f"unknown method {method}")
