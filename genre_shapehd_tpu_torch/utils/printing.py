"""ANSI-prefixed stage / verbose / warning / error strings (counterpart
of ``genre_shapehd_tpu/utils/printing.py``)."""

str_stage = "\x1b[1;32m==>\x1b[0m"
str_verbose = "\x1b[1;34m  ->\x1b[0m"
str_warning = "\x1b[1;33mWARNING:\x1b[0m"
str_error = "\x1b[1;31mERROR:\x1b[0m"
