"""What the ranks of ``tests/test_torch_parallel_sptp.py``'s worlds run
besides ``parallel.dryrun``: single layers split over ``sp`` and the
gathered state dict of a sharded model. Spawned ranks import this module
by name, so it imports no JAX.
"""

import numpy as np
import torch
from torch import nn

from tpuir_torch.parallel.collectives import all_reduce, gather_same
from tpuir_torch.parallel.mesh import batch_sharding, make_mesh

SIDE, CHANNELS, HEADS = 8, 8, 2


def seeded_layers(seed=0):
    """A dense 3x3 conv with a bias, a depthwise 3x3, an MDTA and a mixer
    (float32, seeded), and their input (2, C, SIDE, SIDE) and the weights
    of the loss sum(out * w) of each: the unsharded modules' case."""
    from tpuir_torch.models.mair import SSMixer, init_state_dict
    from tpuir_torch.models.restormer import MDTA

    torch.manual_seed(seed)
    layers = {"conv": nn.Conv2d(CHANNELS, CHANNELS, 3, padding=1),
              "depthwise": nn.Conv2d(CHANNELS, CHANNELS, 3, padding=1, groups=CHANNELS),
              "mdta": MDTA(CHANNELS, HEADS, bias=False),
              "mixer": SSMixer(CHANNELS, d_state=4, expand=1.5, fused=True)}
    sd = init_state_dict(dict(embed_dim=CHANNELS, depths=(1,), d_state=4, ssm_ratio=1.5),
                         seed)
    prefix = "layers.0.residual_group.blocks.0.self_attention."
    layers["mixer"].load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                                     if k.startswith(prefix)})
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.rand(2, CHANNELS, SIDE, SIDE).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, CHANNELS, SIDE, SIDE).astype(np.float32))
    return layers, x, w


def run_layer(name, layer, x, w):
    """(output, input gradient, {parameter: gradient}) of sum(layer(x) * w);
    the mixer takes and gives NHWC."""
    x = x.clone().requires_grad_(True)
    out = layer(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2) if name == "mixer" else layer(x)
    (out * w).sum().backward()
    return out.detach(), x.grad, {k: p.grad for k, p in layer.named_parameters()}


def spatial_layers(axes, seed=0):
    """On this rank's rows over ``sp``: each of ``seeded_layers`` split by
    ``parallelize_spatial``; returns {layer: (output, input gradient,
    parameter gradients)}, the rows gathered and the parameter gradients
    summed over ``sp``, as NumPy."""
    from tpuir_torch.parallel.spatial import parallelize_spatial

    mesh = make_mesh(axes)
    group = mesh.group("sp")
    layers, x, w = seeded_layers(seed)
    _, rows = batch_sharding(mesh, x.shape[0], x.shape[2])
    out = {}
    for name, layer in layers.items():
        holder = nn.Sequential(layer)
        parallelize_spatial(holder, mesh)
        y, gx, gp = run_layer(name, holder[0], x[:, :, rows], w[:, :, rows])
        out[name] = (gather_same(y, 2, group).numpy(), gather_same(gx, 2, group).numpy(),
                     {k: all_reduce(g, group).numpy() for k, g in gp.items()})
    return out


def sharded_state(axes, network_g, seed, min_dim):
    """``full_state_dict`` of the ``network_g`` model with seeded weights,
    split by ``parallel.train.parallelize``, as NumPy."""
    from tpuir_torch.parallel.tensor import full_state_dict
    from tpuir_torch.parallel.train import parallelize
    from tpuir_torch.train.archs import build_network, init_state_dict

    mesh = make_mesh(axes)
    net = build_network(network_g)
    net.load_state_dict(init_state_dict(network_g, seed))
    parallelize(net, mesh, min_dim)
    return {k: v.numpy() for k, v in full_state_dict(net, mesh).items()}


def dp_gathers(axes):
    """``gather_patches`` of a share that holds this rank's number, by each
    route: {route: the gathered array}."""
    from tpuir_torch.parallel.inference import GATHERS, gather_patches

    mesh = make_mesh(axes)
    local = np.full((1, 1), mesh.rank, np.float32)
    return {route: gather_patches(local, mesh, route, torch.device("cpu")) for route in GATHERS}
