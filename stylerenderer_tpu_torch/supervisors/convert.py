"""Weights of the three supervisor nets (counterpart of
``stylerenderer_tpu/supervisors/convert.py``).

The port's nets carry the published layouts' module names, so a published
state dict loads by name with no conversion:

- face_normals ``ResNetUNet(n_class=3)`` (``data/model.pth``, torchvision's
  resnet18 trunk names; the file registers the trunk twice, as
  ``base_model.*`` beside the bare names, and either is accepted);
- pytorch_face_landmark's ``PFLDInference``
  (``pfld_model_best.pth.tar['state_dict']``, PFLD-pytorch's names, with or
  without a ``module.`` / ``pfld_backbone.`` prefix);
- facenet-pytorch's ``InceptionResnetV1`` (the vggface2 checkpoint).

The loaders (``load_face_normals``, ``load_pfld``, ``load_facenet``) take
a path or a state dict and are loud as the JAX converters are: a key the
net needs and the file lacks raises ``KeyError`` naming it. Keys the file
carries beyond what the net needs are dropped, as the JAX converters
ignore them (the duplicate trunk, facenet's ``logits.*``,
``num_batches_tracked``).
Without weights, ``random_stand_in_`` draws a fixed-seed network with
flax's default initializers, as the JAX package's heads do: truncated
``lecun_normal`` kernels, zero biases, batch norm at identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stylerenderer_tpu_torch.eval.inception import lecun_normal_


class BatchNorm(nn.BatchNorm2d):
    """Batch norm in inference form, always with its stored statistics
    (the supervisors are frozen critics); takes ``[B, C, H, W]`` or
    ``[B, C]``."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def _load(path_or_sd, subkey: str | None = None) -> dict:
    """A path (``torch.load`` on the CPU) or a state dict; ``subkey`` (PFLD's
    ``state_dict``) is taken when present, a pickled module gives its own."""
    sd = torch.load(path_or_sd, map_location="cpu") if isinstance(path_or_sd, str) \
        else path_or_sd
    if subkey and subkey in sd:
        sd = sd[subkey]
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd


def load_published(net: nn.Module, sd: dict) -> nn.Module:
    """Load ``net`` by name from the state dict ``sd``: every parameter and
    statistic ``net`` holds must be there (``KeyError`` names the first
    missing one); ``num_batches_tracked`` and every other key are dropped.
    Returns ``net``."""
    want = {}
    for k, v in net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            want[k] = v
            continue
        if k not in sd:
            raise KeyError(f"{k} is missing from the {type(net).__name__} weights")
        want[k] = torch.as_tensor(sd[k])
    net.load_state_dict(want, strict=True)
    return net


def load_face_normals(net: nn.Module, path_or_sd) -> nn.Module:
    """face_normals ``model.pth``: the bare trunk names, else
    ``base_model.*``."""
    sd = _load(path_or_sd)
    if "base_model.conv1.weight" in sd and "conv1.weight" not in sd:
        sd = {k.removeprefix("base_model."): v for k, v in sd.items()}
    return load_published(net, sd)


def load_pfld(net: nn.Module, path_or_sd) -> nn.Module:
    """PFLD: the ``state_dict`` subkey, without a ``module.`` or
    ``pfld_backbone.`` prefix."""
    sd = _load(path_or_sd, subkey="state_dict")
    for pre in ("module.", "pfld_backbone."):
        if any(k.startswith(pre) for k in sd):
            sd = {k.removeprefix(pre): v for k, v in sd.items()}
    return load_published(net, sd)


def load_facenet(net: nn.Module, path_or_sd) -> nn.Module:
    """facenet-pytorch's ``InceptionResnetV1`` state dict."""
    return load_published(net, _load(path_or_sd))


def random_stand_in_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """In place, flax's default init, module by module in registration
    order: conv and linear kernels truncated normal (+-2 std) with
    variance 1/fan_in, biases 0, batch norm at identity."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return net
