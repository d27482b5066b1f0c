#!/usr/bin/env python3
"""Where UniDepth-L's forward spends its device time, on one CUDA card.

UniDepth-L (seeded random weights) at 532×952, the net input of a 720p
frame, in bf16 as SLAM's keyframe prior runs it: the whole forward, the
ViT alone and the decoder alone by CUDA events (warm, ``chip_smoke.py``'s
timer), then a ``torch.profiler`` table of three forwards by device time,
then the forward with the weights and input in channels-last layout, with
cuDNN's autotuner off and on.  Prints the card's name and power limit
first.

    python3 scripts/profile_unidepth.py
"""

import copy
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

H, W = 532, 952


def main():
    cs._require_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs._card_line(), flush=True)
    from torch.profiler import ProfilerActivity, profile

    from vipe_tpu_torch.priors.depth.unidepth import UniDepthNet, init_unidepth_, pinhole_rays

    net = init_unidepth_(UniDepthNet("vitl"), 0).eval().requires_grad_(False)
    net = net.cuda().bfloat16()
    x = torch.randn((1, 3, H, W), device="cuda").bfloat16()
    rays = pinhole_rays(torch.tensor([[663.0, 663.0, W / 2, H / 2]]), (H, W)).cuda().bfloat16()
    with torch.no_grad():
        print("forward_ms", cs._cuda_ms(lambda: net(x, rays), 5), flush=True)
        taps = net.pixel_encoder(x, net.taps)
        print("vit_ms", cs._cuda_ms(lambda: net.pixel_encoder(x, net.taps), 5), flush=True)
        feats, cls = [t for t, _ in taps], [c for _, c in taps]
        print("decoder_ms", cs._cuda_ms(lambda: net.pixel_decoder(feats, cls, (H, W), rays), 5),
              flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                net(x, rays)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                        max_name_column_width=70), flush=True)
        cl = copy.deepcopy(net).to(memory_format=torch.channels_last)
        xc = x.contiguous(memory_format=torch.channels_last)
        for benchmark in (False, True):
            torch.backends.cudnn.benchmark = benchmark
            print(f"cudnn.benchmark={benchmark} channels_last_forward_ms",
                  cs._cuda_ms(lambda: cl(xc, rays), 5),
                  "nchw_forward_ms", cs._cuda_ms(lambda: net(x, rays), 5), flush=True)


if __name__ == "__main__":
    main()
