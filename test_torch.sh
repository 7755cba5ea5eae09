#!/usr/bin/env bash
# canonical evaluation command (reference test.sh) with the PyTorch/CUDA
# port: FrameSampler over the test sequences with the progressive renderer,
# on the GPU (add `device cpu` to run on the CPU)
python tools/inference_torch.py --cfg configs/trainzju_valzju.yaml \
    render.file 'demo_render' \
    render.resume_path "${1:?usage: test_torch.sh <checkpoint.pth> [key value ...]}" \
    dataset.test.sampler 'FrameSampler' \
    dataset.test.shuffle False \
    test.is_vis True \
    "${@:2}"
