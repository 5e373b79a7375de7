#!/usr/bin/env bash
# Stage 2: 2.5D -> voxels (port of scripts/train_marrnet2.sh)
source "$(dirname "$0")/common.sh"
outdir=./output/marrnet2
class="${1:?Usage: $0 class [extra flags...]}"; shift
python -m genre_shapehd_tpu_torch.cli.train \
    --net marrnet2 --canon_sup \
    --dataset shapenet --classes "$class" \
    --batch_size 4 --epoch_batches 2500 --eval_batches 5 \
    --log_time --optim adam --lr 1e-3 --epoch 1000 \
    --vis_batches_vali 10 --save_net 10 --workers 4 \
    --logdir "$outdir" --suffix '{classes}' $(tensorboard) "$@"
