"""Where CREPE full's time goes on the card, layer by layer.

    python3 scripts/profile_torch_crepe.py [--frames 1024]

Random torchcrepe-named weights (``models/crepe.random_state_dict``), one
batch of normalized frames, float32 with TF32 off (as the port runs it).
For each conv: cuDNN's route (``Conv2d``) and the product of the unfolded
windows with the weight (``models/crepe._conv``'s route where the output is
short), CUDA-event ms and achieved TFLOP/s; then the whole net and the
kernels the profiler saw, by device time. Prints the card's name and power
limit.
"""
import argparse
import subprocess

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from rvc_tpu_torch.device import set_float32_math
from rvc_tpu_torch.models import crepe
from rvc_tpu_torch.models.layers import load_numpy_state_dict


def timed(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def unfolded(conv, x):
    """The conv as one product of its unfolded windows, at any output length."""
    k, s = conv.kernel_size[0], conv.stride[0]
    N, C, H, _ = x.shape
    h_out = (H - k) // s + 1
    cols = x[..., 0].unfold(2, k, s).transpose(1, 2).reshape(N * h_out, C * k)
    y = cols @ conv.weight.reshape(conv.out_channels, -1).T + conv.bias
    return y.reshape(N, h_out, -1).permute(0, 2, 1)[..., None]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=1024)
    args = p.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    set_float32_math()
    net = load_numpy_state_dict(crepe.CrepeNet("full"),
                                crepe.random_state_dict("full", 5)).cuda().eval()
    x = torch.randn(args.frames, crepe.WINDOW, device="cuda")
    with torch.no_grad():
        h = x[:, None, :, None]
        for i in range(6):
            conv = getattr(net, f"conv{i + 1}")
            hp = F.pad(h, (0, 0) + crepe._PADS[i])
            k, s = conv.kernel_size[0], conv.stride[0]
            h_out = (hp.shape[2] - k) // s + 1
            flops = 2 * hp.shape[0] * conv.out_channels * conv.in_channels * k * h_out
            line = f"conv{i + 1} in {tuple(hp.shape)} out H {h_out}: "
            for name, fn in (("cudnn", conv), ("unfolded", lambda t, c=conv: unfolded(c, t))):
                cols_gb = hp.shape[0] * h_out * conv.in_channels * k * 4 / 2**30
                if name == "unfolded" and cols_gb > 8:
                    line += f"unfolded skipped ({cols_gb:.0f} GiB of windows); "
                    continue
                ms = timed(lambda: fn(hp))
                line += f"{name} {ms:.2f} ms ({flops / ms / 1e9:.1f} TFLOP/s); "
            print(line + f"route taken: {'unfolded' if h_out <= 32 else 'cudnn'}")
            h = F.max_pool2d(getattr(net, f"conv{i + 1}_BN")(torch.relu(conv(hp))), (2, 1), (2, 1))
        print(f"net on {args.frames} frames: {timed(lambda: net(x)):.2f} ms")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=10,
                                    max_name_column_width=80))


if __name__ == "__main__":
    main()
