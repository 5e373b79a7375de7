#!/usr/bin/env bash
# Test ShapeHD on photos (port of scripts/test_shapehd.sh)
source "$(dirname "$0")/common.sh"
out_dir=./output/test
shapehd=${NET_FILE:?set NET_FILE=/path/to/shapehd.pt}
marrnet1=${MARRNET1_FILE:?set MARRNET1_FILE=/path/to/marrnet1.pt}
rgb_pattern=${RGB:-'./downloads/data/test/shapehd/*_rgb.*'}
mask_pattern=${MASK:-'./downloads/data/test/shapehd/*_mask.*'}
python -m genre_shapehd_tpu_torch.cli.test \
    --net shapehd --net_file "$shapehd" --marrnet1_file "$marrnet1" \
    --input_rgb "$rgb_pattern" --input_mask "$mask_pattern" \
    --output_dir "$out_dir" --suffix '{net}' --overwrite \
    --workers 0 --batch_size 1 --vis_workers 4 "$@"
