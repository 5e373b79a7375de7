#!/usr/bin/env bash
# GenRe stage 3: full model w/ voxel refinement
# (port of scripts/train_full_genre.sh)
source "$(dirname "$0")/common.sh"
outdir=./output/genre
inpaint_path=${INPAINT:?set INPAINT=/path/to/trained/inpaint.pt}
class="${1:?Usage: $0 class [extra flags...]}"; shift
python -m genre_shapehd_tpu_torch.cli.train \
    --net genre_full_model --pred_depth_minmax \
    --dataset shapenet --classes "$class" \
    --batch_size 4 --epoch_batches 1000 --eval_batches 30 \
    --log_time --optim adam --lr 1e-4 --epoch 1000 \
    --vis_batches_vali 10 --save_net 10 --workers 4 \
    --logdir "$outdir" --suffix '{classes}' $(tensorboard) \
    --surface_weight 10 --inpaint_path "$inpaint_path" "$@"
