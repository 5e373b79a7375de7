#!/usr/bin/env bash
# Shared plumbing of the PyTorch port's launch scripts.  Each one is the
# script of the same name in scripts/ with the module swapped for
# genre_shapehd_tpu_torch's: the same variables, the same arguments,
#   ./scripts_torch/script.sh CLASS [extra flags...]
# The port runs on the GPU (--device cuda) unless given --device cpu.
set -e
cd "$(dirname "$0")/.."

# Prints --tensorboard where tensorboardX can be imported.  Elsewhere it
# prints nothing and says on stderr that the flag was left out: the
# port's cli.train stops before its first step on --tensorboard without
# tensorboardX.
tensorboard() {
    if python -c 'import tensorboardX' 2>/dev/null; then
        echo --tensorboard
    else
        echo "$(basename "$0"): tensorboardX is not installed;" \
            "leaving out --tensorboard" >&2
    fi
}
