#!/usr/bin/env bash
# GenRe stage 4 (beyond the reference): joint end-to-end fine-tune
# (port of scripts/finetune_genre_joint.sh).
# Resumes a train_full_genre.sh logdir and keeps training the WHOLE
# chain -- voxel-loss gradients flow through spherical bp -> inpaint ->
# render -> cam_bp into net1, which the reference cannot do (its
# test-time spherical projection is non-differentiable ray casting,
# util/util_sph.py:36-57).  --joint_train/--joint_w25d are
# unique_params, so they apply on resume; the other saved options
# (including --lr, as in the reference's resume semantics,
# options_train.py:91-106) are restored from the logdir's opt.pt.
# --joint_w25d balances the ~300-scale 2.5D supervision against the
# ~0.05 voxel BCE.
source "$(dirname "$0")/common.sh"
outdir=./output/genre
class="${1:?Usage: $0 class [extra flags...]}"; shift
python -m genre_shapehd_tpu_torch.cli.train \
    --net genre_full_model --pred_depth_minmax \
    --joint_train --joint_w25d 0.01 \
    --dataset shapenet --classes "$class" \
    --batch_size 4 --epoch_batches 1000 --eval_batches 30 \
    --logdir "$outdir" --suffix '{classes}' $(tensorboard) \
    --resume -1 "$@"
