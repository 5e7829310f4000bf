"""Device resolution: spec device strings -> mesh indices and torch devices.

Counterpart of ``autodist_tpu/kernel/device/resolver.py``: a device string
``"host:GPU:0"`` resolves to ``"mesh:<flat index>"`` in node-major order,
and :func:`torch_device` turns it into the ``torch.device`` it names.
:func:`resolve_device` is the entry points' rule: ``cuda`` unless the caller
asks for ``"cpu"``, and an error, never a silent CPU run, when there is no
GPU.
"""
import torch

from autodist_tpu_torch.resource_spec import DeviceSpec, DeviceType


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises without a GPU); ``"cpu"`` -> cpu;
    ``"cuda[:i]"`` -> that GPU (raises without one)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda[:i]' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_device(device_string):
    """``"host:GPU:i"`` -> ``cuda:i``; ``"host:CPU:i"`` / ``"host"`` -> cpu."""
    d = DeviceSpec.from_string(device_string)
    if d.device_type == DeviceType.CPU:
        return torch.device("cpu")
    if d.device_type == DeviceType.GPU:
        return torch.device("cuda", d.device_index)
    raise ValueError(f"{device_string!r} names no device this port runs on")


class DeviceResolver:
    def __init__(self, resource_spec):
        self._spec = resource_spec
        # node-major ordering: nodes in spec order, devices in index order
        names = [n for n, _ in resource_spec.accelerator_devices] or \
            [n for n, _ in resource_spec.cpu_devices]
        self._flat = {name: i for i, name in enumerate(names)}

    def resolve(self, device_string):
        """'host:GPU:0' -> 'mesh:<flat_index>'; resolved strings pass through."""
        if device_string.startswith("mesh:"):
            return device_string
        if device_string not in self._flat:
            # a bare address anchors at the node's first device
            d = DeviceSpec.from_string(device_string)
            for name, dev in self._spec.devices:
                if dev.address == d.address and name in self._flat:
                    return f"mesh:{self._flat[name]}"
            raise ValueError(f"Cannot resolve device {device_string!r}")
        return f"mesh:{self._flat[device_string]}"
