"""The evaluation harness of the port: VDE drift, quality deltas and the
VBench metric plug-ins (copies of `inferix_tpu/eval/`)."""
