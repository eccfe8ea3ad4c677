#!/bin/bash
# The port's counterpart of configs/ablation.sh: the attention-kernel
# ablation on Cora (--attention {simple,softmax,gat,performer}) through
# python -m sgformer_tpu_torch.cli.main, on the GPU (pass --device cpu for
# the CPU). The same flags, one run per kernel.
set -e
RUN="python -m sgformer_tpu_torch.cli.main --trainer full --method sgformer"
for KERNEL in simple softmax gat performer; do
$RUN --backbone gcn --dataset cora --attention "$KERNEL" \
    --lr 0.01 --gnn_num_layers 4 --hidden_channels 64 \
    --gnn_weight_decay 5e-4 --gnn_dropout 0.5 --trans_num_layers 1 \
    --graph_weight 0.8 --trans_dropout 0.2 --alpha 0.5 \
    --rand_split_class --no_feat_norm --seed 123 --runs 5 --epochs 500 "$@"
done
