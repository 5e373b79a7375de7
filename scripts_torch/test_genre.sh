#!/usr/bin/env bash
# Test GenRe on photos (port of scripts/test_genre.sh)
source "$(dirname "$0")/common.sh"
out_dir=./output/test
fullmodel=${NET_FILE:?set NET_FILE=/path/to/full_model.pt}
rgb_pattern=${RGB:-'./downloads/data/test/genre/*_rgb.*'}
mask_pattern=${MASK:-'./downloads/data/test/genre/*_silhouette.*'}
python -m genre_shapehd_tpu_torch.cli.test \
    --net genre_full_model --net_file "$fullmodel" \
    --input_rgb "$rgb_pattern" --input_mask "$mask_pattern" \
    --output_dir "$out_dir" --suffix '{net}' --overwrite \
    --workers 0 --batch_size 1 --vis_workers 4 "$@"
