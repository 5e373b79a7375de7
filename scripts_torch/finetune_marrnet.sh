#!/usr/bin/env bash
# Finetune MarrNet-2 end-to-end behind frozen MarrNet-1
# (port of scripts/finetune_marrnet.sh)
source "$(dirname "$0")/common.sh"
outdir=./output/marrnet
marrnet1=${MARRNET1:?set MARRNET1=/path/to/marrnet1.pt}
marrnet2=${MARRNET2:?set MARRNET2=/path/to/marrnet2.pt}
class="${1:?Usage: $0 class [extra flags...]}"; shift
python -m genre_shapehd_tpu_torch.cli.train \
    --net marrnet --canon_sup \
    --marrnet1 "$marrnet1" --marrnet2 "$marrnet2" \
    --dataset shapenet --classes "$class" \
    --batch_size 4 --epoch_batches 1000 --eval_batches 10 \
    --log_time --optim adam --lr 1e-4 --epoch 1000 \
    --vis_batches_vali 10 --save_net 10 --workers 4 \
    --logdir "$outdir" --suffix '{classes}' $(tensorboard) "$@"
