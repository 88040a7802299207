"""The plain reference against the port, at a tiny width on the CPU: the same
weights (drawn by portbench.weights) give the same outputs."""

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference import nets
from portbench.reference.lowprec import CONTROLS

NET = dict(num_in_ch=24, num_out_ch=3, num_feat=16, num_grow_ch=8, num_block=2)


def _inputs():
    sd = weights.rrdbnet_weights(NET, 11, "cpu")
    x = torch.rand(2, 8, 8, 24, generator=torch.Generator().manual_seed(0))
    return sd, x


def test_rrdbnet_matches_the_port():
    from satlas_sr_tpu_torch.archs.rrdbnet import RRDBNet

    sd, x = _inputs()
    model = RRDBNet(24, 3, num_feat=16, num_grow_ch=8, num_block=2, device="cpu")
    model.load_state_dict(sd)
    with torch.no_grad():
        torch.testing.assert_close(model(x), nets.rrdbnet(sd, x, 2), rtol=1e-5, atol=1e-5)


def test_trunk_conv_computes_the_dense_blocks_alone():
    """`trunk_conv` reaches every dense block's conv and no other conv."""
    sd, x = _inputs()
    seen = []

    def trunk(h, w, b=None, **kw):
        seen.append(w.data_ptr())
        return F.conv2d(h, w, b, **kw)

    with torch.no_grad():
        same = nets.rrdbnet(sd, x, 2, trunk_conv=trunk)
        torch.testing.assert_close(same, nets.rrdbnet(sd, x, 2), rtol=0, atol=0)
        trunk_low = nets.rrdbnet(sd, x, 2, trunk_conv=CONTROLS["float32"])
        all_low = nets.rrdbnet(sd, x, 2, conv=CONTROLS["float32"])
    blocks = {sd[k].data_ptr() for k in sd if k.startswith("body.") and k.endswith(".weight")}
    assert set(seen) == blocks and len(seen) == len(blocks)
    assert not torch.equal(trunk_low, same) and not torch.equal(trunk_low, all_low)
