"""MuseTalk's networks: the SD VAE (``vae``), the lip-sync UNet (``unet``)
and the face networks S3FD, BiSeNet and FAN (``face``), in PyTorch's
layout (NCHW) with the state_dict names of the checkpoints they load
(diffusers' AutoencoderKL and UNet2DConditionModel, face-alignment's
S3FD and FAN, face-parsing's BiSeNet). Counterparts of
``rvc_tpu/models/musetalk/``."""
