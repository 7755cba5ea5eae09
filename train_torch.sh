#!/usr/bin/env bash
# canonical training command (reference train.sh) with the PyTorch/CUDA
# port, on the GPU (add `device cpu` to run on the CPU)
python tools/train_torch.py --cfg configs/trainzju_valzju.yaml "$@"
