#!/bin/bash
# The port's counterpart of configs/large.sh: the same flags through
# python -m sgformer_tpu_torch.cli.main, on the GPU (pass --device cpu
# for the CPU). The TPU layout flags (--use_pallas, --spmm_mode,
# --hub_rows) are accepted and ignored there (sgformer_tpu_torch/cli/main.py).
# Reproduction recipes for the large tier — mirrors
# the SGFormer reference's large/run.sh (published numbers in comments).
set -e
RUN="python -m sgformer_tpu_torch.cli.main --method sgformer --backbone graphconv --trans_residual_mode mean --use_pallas"

# ogbn-arxiv, reference: 72.63 ± 0.13 (full-graph).
$RUN --trainer full --dataset ogbn-arxiv --metric acc --lr 0.001 \
    --spmm_mode ssel --hub_rows -1 \
    --hidden_channels 256 --graph_weight 0.5 --gnn_num_layers 3 \
    --gnn_dropout 0.5 --gnn_weight_decay 0. --trans_num_layers 1 \
    --trans_dropout 0.5 --trans_weight_decay 0. \
    --seed 123 --runs 5 --epochs 1000 --eval_step 9 "$@"

# ogbn-proteins, reference: 79.53 ± 0.38 (mini-batch 10k, rocauc)
$RUN --trainer batch --dataset ogbn-proteins --metric rocauc --lr 0.01 \
    --hidden_channels 64 --graph_weight 0.5 --gnn_num_layers 2 \
    --gnn_dropout 0. --gnn_weight_decay 0. --trans_num_layers 1 \
    --trans_dropout 0. --trans_weight_decay 0. \
    --batch_size 10000 --seed 123 --runs 5 --epochs 1000 --eval_step 9 "$@"

# amazon2m (ogbn-products graph), reference: 89.09 ± 0.10 (mini-batch 100k)
$RUN --trainer batch --dataset amazon2m --metric acc --lr 0.01 \
    --hidden_channels 256 --graph_weight 0.5 --gnn_num_layers 3 \
    --gnn_dropout 0. --gnn_weight_decay 0. --gnn_use_init \
    --trans_num_layers 1 --trans_dropout 0. --trans_weight_decay 0. \
    --rand_split --batch_size 100000 --seed 123 --runs 5 --epochs 1000 \
    --eval_step 9 "$@"

# pokec, reference: 74.76 ± 0.24 (mini-batch 100k)
$RUN --trainer batch --dataset pokec --rand_split --metric acc --lr 0.01 \
    --hidden_channels 64 --graph_weight 0.5 --gnn_num_layers 2 \
    --gnn_dropout 0. --gnn_weight_decay 0. --gnn_use_init \
    --trans_num_layers 1 --trans_dropout 0. --trans_weight_decay 0. \
    --batch_size 100000 --seed 123 --runs 5 --epochs 1000 --eval_step 9 "$@"
