#!/usr/bin/env bash
# ShapeHD: finetune MarrNet-2 with the frozen WGAN-GP critic
# (port of scripts/finetune_shapehd.sh)
source "$(dirname "$0")/common.sh"
outdir=./output/shapehd
marrnet2=${MARRNET2:?set MARRNET2=/path/to/marrnet2.pt}
gan=${GAN:?set GAN=/path/to/wgangp.pt}
w_gan_loss=${W_GAN_LOSS:-0.001}
class="${1:?Usage: $0 class [extra flags...]}"; shift
python -m genre_shapehd_tpu_torch.cli.train \
    --net shapehd --canon_sup \
    --marrnet2 "$marrnet2" --gan "$gan" --w_gan_loss "$w_gan_loss" \
    --dataset shapenet --classes "$class" \
    --batch_size 4 --epoch_batches 1000 --eval_batches 10 \
    --log_time --optim adam --lr 1e-4 --epoch 1000 \
    --vis_batches_vali 10 --save_net 10 --workers 4 \
    --logdir "$outdir" --suffix '{classes}_w_ganloss{w_gan_loss}' \
    $(tensorboard) "$@"
