#!/usr/bin/env bash
# GenRe stage 2: depth + spherical inpainting
# (port of scripts/train_inpaint.sh)
source "$(dirname "$0")/common.sh"
outdir=./output/inpaint
class="${1:?Usage: $0 class [extra flags...]}"; shift
python -m genre_shapehd_tpu_torch.cli.train \
    --net depth_pred_with_sph_inpaint --pred_depth_minmax \
    ${NET1:+--net1_path "$NET1"} \
    --dataset shapenet --classes "$class" \
    --batch_size 4 --epoch_batches 1000 --eval_batches 30 \
    --log_time --optim adam --lr 1e-4 --epoch 1000 \
    --vis_batches_vali 10 --save_net 10 --workers 4 \
    --logdir "$outdir" --suffix '{classes}' $(tensorboard) "$@"
