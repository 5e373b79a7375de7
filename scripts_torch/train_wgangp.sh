#!/usr/bin/env bash
# 3D-WGAN-GP shape prior (port of scripts/train_wgangp.sh)
source "$(dirname "$0")/common.sh"
outdir=./output/wgangp
class="${1:?Usage: $0 class [extra flags...]}"; shift
python -m genre_shapehd_tpu_torch.cli.train \
    --net wgangp --canon_voxel \
    --dataset shapenet --classes "$class" \
    --batch_size 4 --epoch_batches 1000 --eval_batches 10 \
    --log_time --optim adam --lr 1e-4 --epoch 1000 \
    --vis_batches_vali 10 --save_net 10 --workers 4 \
    --logdir "$outdir" --suffix '{classes}' $(tensorboard) "$@"
