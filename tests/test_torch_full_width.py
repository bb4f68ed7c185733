"""The port's entry point at full width on the CPU: make_random_converter
builds the 48k_v2 converter (full-size HuBERT and RMVPE) from seeded numpy
and converts 1 s through the plain versions of the kernels."""
import numpy as np
import torch

from rvc_tpu_torch.models.hubert import conv_output_lengths
from rvc_tpu_torch.pipelines.convert import make_random_converter


def test_make_random_converter_full_width_on_cpu():
    """48k_v2 at full width on the CPU (plain versions): 1 s converts to
    int16 at 48 kHz of the length the span gives, not silent. Weight-normed
    convs hold v / |v| rows; gains are ones and biases zeros."""
    vc = make_random_converter("48k_v2", chunking=(1, 5, 16, 20), index_rows=1000,
                               device="cpu")
    w = vc.synth.dec.resblocks[0].convs1[0].weight.detach()
    torch.testing.assert_close(w.flatten(1).norm(dim=1), torch.ones(w.shape[0]))
    assert torch.all(vc.synth.enc_p.encoder.norm_layers_1[0].gamma == 1)
    assert torch.all(vc.synth.dec.conv_pre.bias == 0)
    audio = (0.1 * np.random.default_rng(0).standard_normal(16000)).astype(np.float32)
    out, sr = vc.convert(audio)
    (b, e), = vc.spans(audio)
    L = -(-(e - b) // 1600) * 1600  # the length bucket
    frames = min((e - b) // 160, 2 * int(conv_output_lengths(vc.hubert.cfg, torch.tensor(L))))
    assert sr == 48000 and out.dtype == np.int16
    assert len(out) == frames * 480 - 2 * vc.t_pad_tgt
    assert np.abs(out.astype(np.int32)).max() > 0
