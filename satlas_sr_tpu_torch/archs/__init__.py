"""Network architectures of the port: the SSR_RRDBNet generator, SRCNN and HighResNet,
the U-Net SN discriminator and the OSM-object discriminator."""

from .discriminator import UNetDiscriminatorSN
from .highresnet import HighResNet
from .osm_discriminator import OSMObjDiscriminator, SelfAttentionBlock
from .rrdbnet import RRDB, RRDBNet, ResidualDenseBlock
from .srcnn import SRCNN

__all__ = ["HighResNet", "OSMObjDiscriminator", "RRDB", "RRDBNet", "ResidualDenseBlock", "SRCNN",
           "SelfAttentionBlock", "UNetDiscriminatorSN"]
