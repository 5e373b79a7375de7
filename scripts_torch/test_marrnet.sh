#!/usr/bin/env bash
# Test MarrNet on photos (port of scripts/test_marrnet.sh)
source "$(dirname "$0")/common.sh"
out_dir=./output/test
marrnet=${NET_FILE:?set NET_FILE=/path/to/marrnet.pt}
rgb_pattern=${RGB:-'./downloads/data/test/shapehd/*_rgb.*'}
mask_pattern=${MASK:-'./downloads/data/test/shapehd/*_mask.*'}
python -m genre_shapehd_tpu_torch.cli.test \
    --net marrnet --net_file "$marrnet" \
    --input_rgb "$rgb_pattern" --input_mask "$mask_pattern" \
    --output_dir "$out_dir" --suffix '{net}' --overwrite \
    --workers 0 --batch_size 1 --vis_workers 4 "$@"
