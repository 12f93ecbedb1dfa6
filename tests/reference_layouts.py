"""State dicts in the reference's torch layouts, for the tests of the
torch checkpoint import: seeded copies of the state_dict functions of
``tests/test_api.py`` (GMatcher, models/gmatcher.py:165-217) and
``tests/test_carhynet.py`` (CAR-HyNet, carhynet/models.py:311-399), with
random values everywhere so that a misplaced leaf shows."""

import numpy as np


def gmatcher_state_dict(rng, layers=2):
    """tests/test_api.py's reference-layout GMatcher state_dict."""
    sd = {}

    def conv1d(p, o, i):
        sd[f"{p}.weight"] = rng.randn(o, i, 1).astype(np.float32) * 0.05
        sd[f"{p}.bias"] = rng.randn(o).astype(np.float32) * 0.01

    def bn(p, c):
        sd[f"{p}.weight"] = rng.rand(c).astype(np.float32) + 0.5
        sd[f"{p}.bias"] = rng.randn(c).astype(np.float32) * 0.01
        sd[f"{p}.running_mean"] = rng.randn(c).astype(np.float32) * 0.01
        sd[f"{p}.running_var"] = rng.rand(c).astype(np.float32) + 0.5
        sd[f"{p}.num_batches_tracked"] = np.array(1)

    dims = [2, 32, 64, 128, 256, 256]
    for i in range(5):
        conv1d(f"kenc.encoder.{3 * i}", dims[i + 1], dims[i])
        if i < 4:
            bn(f"kenc.encoder.{3 * i + 1}", dims[i + 1])
    for n in range(layers):
        for j in range(3):
            conv1d(f"gnn.layers.{n}.attn.proj.{j}", 256, 256)
        conv1d(f"gnn.layers.{n}.attn.merge", 256, 256)
        conv1d(f"gnn.layers.{n}.mlp.0", 512, 512)
        bn(f"gnn.layers.{n}.mlp.1", 512)
        conv1d(f"gnn.layers.{n}.mlp.3", 256, 512)
    for i, (cin, cout) in enumerate([(256, 128), (128, 128), (128, 256)]):
        for fc in ("fc_self", "fc_neigh"):
            sd[f"gnn_encoder.layers.{i}.{fc}.weight"] = rng.randn(cout, cin).astype(
                np.float32) * 0.05
        sd[f"gnn_encoder.layers.{i}.bias"] = rng.randn(cout).astype(np.float32) * 0.01
    conv1d("final_proj", 256, 256)
    sd["bin_score"] = np.array(1.0, np.float32)
    return sd


def carhynet_state_dict(rng):
    """tests/test_carhynet.py's reference-layout CAR-HyNet state_dict."""
    sd = {}

    def conv(p, o, i, k, bias=True):
        sd[f"{p}.weight"] = rng.randn(o, i, k, k).astype(np.float32) * 0.1
        if bias:
            sd[f"{p}.bias"] = rng.randn(o).astype(np.float32) * 0.01

    def frn(p, c):
        sd[f"{p}.weight"] = rng.rand(1, c, 1, 1).astype(np.float32) + 0.5
        sd[f"{p}.bias"] = rng.randn(1, c, 1, 1).astype(np.float32) * 0.01
        sd[f"{p}.eps"] = np.array([1e-6], np.float32)

    def tlu(p, c):
        sd[f"{p}.tau"] = rng.randn(1, c, 1, 1).astype(np.float32)

    def bn(p, c, affine=True):
        if affine:
            sd[f"{p}.weight"] = rng.rand(c).astype(np.float32) + 0.5
            sd[f"{p}.bias"] = rng.randn(c).astype(np.float32) * 0.01
        sd[f"{p}.running_mean"] = rng.randn(c).astype(np.float32) * 0.01
        sd[f"{p}.running_var"] = rng.rand(c).astype(np.float32) + 0.5
        sd[f"{p}.num_batches_tracked"] = np.array(100)

    def coord(p, c):
        mip = max(8, c // 32)
        conv(f"{p}.conv1", mip, c, 1)
        bn(f"{p}.bn1", mip)
        conv(f"{p}.conv_h", c, mip, 1)
        conv(f"{p}.conv_w", c, mip, 1)

    def sandglass(p, c):
        sd[f"{p}.conv.0.0.weight"] = rng.randn(c, 1, 3, 3).astype(np.float32) * 0.1
        bn(f"{p}.conv.0.1", c)
        coord(f"{p}.conv.1", c)
        conv(f"{p}.conv.2", 16, c, 1, bias=False)
        bn(f"{p}.conv.3", 16)
        conv(f"{p}.conv.4.0", c, 16, 1, bias=False)
        bn(f"{p}.conv.4.1", c)
        sd[f"{p}.conv.5.weight"] = rng.randn(c, 1, 3, 3).astype(np.float32) * 0.1
        bn(f"{p}.conv.6", c)

    frn("layer1.0", 3)
    tlu("layer1.1", 3)
    conv("layer1.2", 32, 3, 3)
    frn("layer1.3", 32)
    coord("layer1.4", 32)
    tlu("layer1.5", 32)
    conv("layer2.0", 32, 32, 3)
    frn("layer2.1", 32)
    coord("layer2.2", 32)
    tlu("layer2.3", 32)
    sandglass("layer2_5", 32)
    for n, (cout, cin) in zip((3, 4, 5, 6), ((64, 32), (64, 64), (128, 64), (128, 128))):
        conv(f"layer{n}.0", cout, cin, 3)
        frn(f"layer{n}.1", cout)
        tlu(f"layer{n}.2", cout)
    sandglass("layer4_5", 64)
    conv("layer7.1", 128, 128, 8, bias=False)
    bn("layer7.2", 128, affine=False)
    return sd
