#!/bin/bash
# The port's counterpart of configs/medium.sh: the same flags through
# python -m sgformer_tpu_torch.cli.main, on the GPU (pass --device cpu
# for the CPU). The TPU layout flags (--use_pallas, --spmm_mode,
# --hub_rows) are accepted and ignored there (sgformer_tpu_torch/cli/main.py).
# Reproduction recipes for the medium tier (full-graph, one chip) —
# mirrors the SGFormer reference's medium/run.sh with this CLI.
# Hyperparameter mapping: ours_layers→trans_num_layers,
# ours_dropout→trans_dropout, ours_weight_decay→trans_weight_decay,
# num_layers (GNN depth)→gnn_num_layers, weight_decay→gnn_weight_decay.
set -e
RUN="python -m sgformer_tpu_torch.cli.main --trainer full --use_pallas --backbone gcn --method sgformer"

# Cora
$RUN --dataset cora --lr 0.01 --gnn_num_layers 4 --hidden_channels 64 \
    --gnn_weight_decay 5e-4 --gnn_dropout 0.5 --trans_num_layers 1 \
    --graph_weight 0.8 --trans_dropout 0.2 --alpha 0.5 \
    --trans_weight_decay 1e-3 --rand_split_class --valid_num 500 \
    --test_num 1000 --no_feat_norm --seed 123 --runs 5 --epochs 500 "$@"

# Citeseer
$RUN --dataset citeseer --lr 0.005 --gnn_num_layers 4 --hidden_channels 64 \
    --gnn_weight_decay 0.01 --gnn_dropout 0.5 --trans_num_layers 1 \
    --graph_weight 0.7 --trans_dropout 0.3 --alpha 0.5 \
    --trans_weight_decay 0.01 --rand_split_class --valid_num 500 \
    --test_num 1000 --no_feat_norm --seed 123 --runs 5 --epochs 500 "$@"

# Pubmed
$RUN --dataset pubmed --lr 0.005 --gnn_num_layers 4 --hidden_channels 64 \
    --gnn_weight_decay 5e-4 --gnn_dropout 0.5 --trans_num_layers 1 \
    --graph_weight 0.8 --trans_dropout 0.3 --alpha 0.5 \
    --trans_weight_decay 0.01 --rand_split_class --valid_num 500 \
    --test_num 1000 --no_feat_norm --seed 123 --runs 5 --epochs 500 "$@"

# Deezer (BCE loss + directed graph handled automatically)
$RUN --dataset deezer-europe --rand_split --lr 0.01 --gnn_num_layers 2 \
    --hidden_channels 96 --gnn_weight_decay 5e-5 --gnn_dropout 0.4 \
    --trans_num_layers 1 --alpha 0.5 --seed 123 --runs 5 --epochs 500 "$@"

# Chameleon
$RUN --dataset chameleon --lr 0.001 --gnn_num_layers 2 --hidden_channels 64 \
    --trans_num_layers 1 --gnn_weight_decay 1e-3 --gnn_dropout 0.6 \
    --alpha 0.5 --runs 10 --epochs 200 "$@"

# Squirrel (DIFFormer recipe in the reference)
python -m sgformer_tpu_torch.cli.main --trainer full --method difformer \
    --dataset squirrel --lr 0.001 --num_layers 8 --hidden_channels 64 \
    --weight_decay 5e-4 --dropout 0.3 --num_heads 1 --alpha 0.5 \
    --runs 10 --epochs 500 "$@"
