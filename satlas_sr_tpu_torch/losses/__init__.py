"""Loss registry package (importing registers the losses the trainers use:
L1, MSE, SSIM, GAN, the VGG19 perceptual loss and the CLIP loss), and the
GAN regularizers."""

from . import perceptual  # registers PerceptualLoss
from .basic import bce_with_logits, build_loss, gan_loss, l1_loss, mse_loss, ssim_loss
from .clip import clip_loss
from .regularizers import g_path_regularize, gradient_penalty_loss, r1_penalty

__all__ = ["bce_with_logits", "build_loss", "clip_loss", "gan_loss", "l1_loss", "mse_loss", "ssim_loss",
           "r1_penalty", "gradient_penalty_loss", "g_path_regularize"]
