#!/bin/bash
# The port's counterpart of configs/100m.sh: the same flags through
# python -m sgformer_tpu_torch.cli.main, on the GPU (pass --device cpu
# for the CPU). The TPU layout flags (--use_pallas, --spmm_mode,
# --hub_rows) are accepted and ignored there (sgformer_tpu_torch/cli/main.py).
# ogbn-papers100M pretrain → finetune — mirrors the SGFormer reference's 100M/run.sh
# (neighbor sampling, fanout [15,10,5], batch 1000, seed-node loss,
# checkpointed best model reloaded for finetuning).
set -e
RUN="python -m sgformer_tpu_torch.cli.main --method sgformer --backbone graphconv --trainer sampled"

# pretrain (23 epochs)
$RUN --dataset ogbn-papers100M --lr 0.001 --gnn_num_layers 3 \
    --hidden_channels 256 --gnn_dropout 0.2 --gnn_weight_decay 1e-5 \
    --gnn_use_init --trans_num_layers 1 --trans_dropout 0.5 \
    --graph_weight 0.8 --batch_size 1000 --fanouts 15 10 5 \
    --seed 123 --runs 1 --epochs 23 --display_step 5 --save_model \
    --model_dir models/papers100m_sgformer "$@"

# finetune (10 epochs from the saved checkpoint)
$RUN --dataset ogbn-papers100M --lr 0.0001 --gnn_num_layers 3 \
    --hidden_channels 256 --gnn_dropout 0.2 --gnn_weight_decay 1e-5 \
    --gnn_use_init --trans_num_layers 1 --trans_dropout 0.5 \
    --graph_weight 0.8 --batch_size 1000 --fanouts 15 10 5 \
    --seed 123 --runs 1 --epochs 10 --display_step 5 --save_model \
    --use_pretrained --model_dir models/papers100m_sgformer "$@"
