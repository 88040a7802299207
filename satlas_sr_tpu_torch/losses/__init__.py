"""Loss registry package (importing registers the losses the ESRGAN trainer
uses: L1, MSE, GAN and the VGG19 perceptual loss)."""

from . import perceptual  # registers PerceptualLoss
from .basic import bce_with_logits, build_loss, gan_loss, l1_loss, mse_loss

__all__ = ["bce_with_logits", "build_loss", "gan_loss", "l1_loss", "mse_loss"]
