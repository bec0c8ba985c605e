"""PyTorch/CUDA port of the sm_distributed_tpu annotation engine."""
