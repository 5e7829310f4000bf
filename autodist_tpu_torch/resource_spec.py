"""Resource specification: the nodes and devices a run may use.

Counterpart of ``autodist_tpu/resource_spec.py`` for GPU hosts.  A spec is a
dict (or a YAML file of the same shape)::

    nodes:
      - address: localhost
        gpus: [0, 1, 2, 3]      # "chips:" is an alias; "cpus:" lists CPUs
        chief: true

Device strings read ``"<address>:GPU:<index>"``.  With no spec, the local
GPUs are detected through ``torch.cuda.device_count()``; with none and no
``device="cpu"`` request that raises.  ``yaml`` is imported only to read a
file.  Left for later (ROADMAP, Queue A item 7b): SSH configs and ``shrink``.
"""
import os
from collections import OrderedDict
from enum import Enum

from autodist_tpu_torch.utils import logging


class ResourceSpecError(ValueError):
    pass


class DeviceType(Enum):
    TPU = 0
    CPU = 1
    GPU = 2


class DeviceSpec:
    """One device, named ``"<address>:<type>:<index>"``."""

    def __init__(self, address, device_index=0, device_type=DeviceType.GPU):
        self.address = address
        self.device_index = int(device_index)
        self.device_type = device_type

    def name_string(self):
        return f"{self.address}:{self.device_type.name}:{self.device_index}"

    @classmethod
    def from_string(cls, name):
        """Parse ``"host:GPU:0"`` / ``"host:CPU:0"`` / ``"host"`` (CPU:0)."""
        parts = name.split(":")
        if len(parts) == 1:
            return cls(parts[0], 0, DeviceType.CPU)
        if len(parts) == 3:
            try:
                dtype = DeviceType[parts[1].upper()]
            except KeyError:
                raise ResourceSpecError(f"Unknown device type in {name!r}") from None
            return cls(parts[0], int(parts[2]), dtype)
        raise ResourceSpecError(f"Cannot parse device string {name!r}")

    def __repr__(self):
        return f"DeviceSpec({self.name_string()})"


def _read_yaml(path):
    try:
        import yaml
    except ImportError:
        raise ResourceSpecError(
            f"reading {path} needs PyYAML, which is not installed; pass the "
            f"spec as a dict (ResourceSpec(resource_info=...)) instead") from None
    with open(path) as f:
        return yaml.safe_load(f)


class ResourceSpec:
    """Parsed resource spec (a dict, a YAML file, or the local GPUs)."""

    def __init__(self, resource_file=None, resource_info=None, device=None):
        """``device="cpu"`` lets the auto-detect fall back to one CPU
        device; otherwise a spec-less run needs a GPU."""
        self._nodes = OrderedDict()
        self._devices = OrderedDict()
        self._chief_address = None
        self._mesh_request = None
        if resource_file is not None:
            if not os.path.exists(resource_file):
                raise ResourceSpecError(f"Resource spec {resource_file} does not exist")
            resource_info = _read_yaml(resource_file)
        if resource_info is None:
            resource_info = self._local_resource_info(device)
        self._from_resource_info(resource_info)
        self._validate()

    @staticmethod
    def _local_resource_info(device):
        if device is not None and str(device) == "cpu":
            return {"nodes": [{"address": "localhost", "cpus": [0], "chief": True}]}
        import torch

        n = torch.cuda.device_count()
        if n == 0:
            raise ResourceSpecError(
                "no CUDA device found to auto-detect a resource spec; pass "
                "device='cpu' or an explicit spec")
        return {"nodes": [{"address": "localhost", "gpus": list(range(n)),
                           "chief": True}]}

    def _from_resource_info(self, info):
        info = dict(info or {})
        later = [k for k in ("ssh", "topology") if info.get(k)]
        if later or any(n.get("ssh_config") for n in info.get("nodes") or []):
            raise NotImplementedError(
                f"resource spec keys {later or ['ssh_config']}: SSH launch is a "
                f"later slice of the port (ROADMAP, Queue A item 7b)")
        self._mesh_request = info.get("mesh")
        nodes = info.get("nodes") or []
        if not nodes:
            raise ResourceSpecError("Resource spec has no nodes")
        for node in nodes:
            self._parse_node(node)

    def _parse_node(self, node):
        address = str(node["address"])
        if address in self._nodes:
            raise ResourceSpecError(f"Duplicate node address {address}")
        is_chief = bool(node.get("chief", False))
        if is_chief:
            if self._chief_address is not None:
                raise ResourceSpecError("Only one node can be chief")
            self._chief_address = address
        # gpus / chips / tpus are aliases: every accelerator here is a GPU
        gpus = node.get("gpus", node.get("chips", node.get("tpus")))
        devices = [DeviceSpec(address, i, DeviceType.GPU) for i in gpus or []]
        devices += [DeviceSpec(address, i, DeviceType.CPU)
                    for i in node.get("cpus", []) or []]
        if not devices:  # a node with no listed accelerators contributes its CPU
            devices = [DeviceSpec(address, 0, DeviceType.CPU)]
        for d in devices:
            self._devices[d.name_string()] = d
        self._nodes[address] = {"address": address, "devices": devices,
                                "chief": is_chief}

    def _validate(self):
        if self._chief_address is None:
            if len(self._nodes) != 1:
                raise ResourceSpecError("Multi-node spec must mark exactly one node as chief")
            self._chief_address = next(iter(self._nodes))
            self._nodes[self._chief_address]["chief"] = True
        local_names = {"localhost", "127.0.0.1"}
        if len(self._nodes) > 1 and any(a in local_names for a in self._nodes):
            raise ResourceSpecError("Loopback address not allowed in a multi-node spec")
        counts = {len(n["devices"]) for n in self._nodes.values()}
        if len(counts) > 1:
            logging.warning("Heterogeneous device counts per node: %s", counts)

    @property
    def chief(self):
        return self._chief_address

    @property
    def nodes(self):
        return list(self._nodes.keys())

    @property
    def node_addresses(self):
        """The node addresses in spec order (the PS builders' candidate
        anchors)."""
        return list(self._nodes.keys())

    @property
    def devices(self):
        """Iterable of (name_string, DeviceSpec)."""
        return self._devices.items()

    @property
    def gpu_devices(self):
        return [(k, v) for k, v in self._devices.items() if v.device_type == DeviceType.GPU]

    @property
    def cpu_devices(self):
        return [(k, v) for k, v in self._devices.items() if v.device_type == DeviceType.CPU]

    @property
    def accelerator_devices(self):
        return [(k, v) for k, v in self._devices.items() if v.device_type != DeviceType.CPU]

    @property
    def num_hosts(self):
        """Hosts of the spec: the nodes that carry accelerators, else (a
        CPU spec) every node; the ``replica_dcn`` size of a two-level mesh
        (:func:`~autodist_tpu_torch.parallel.mesh.hierarchical_axes`)."""
        return (len({d.address for _, d in self.accelerator_devices})
                or len(self.node_addresses))

    @property
    def num_accelerators(self):
        return len(self.accelerator_devices)

    @property
    def mesh_request(self):
        """Optional explicit {axis_name: size} mesh request."""
        return dict(self._mesh_request) if self._mesh_request else None

    def __repr__(self):
        return (f"ResourceSpec(nodes={len(self._nodes)}, "
                f"accelerators={self.num_accelerators}, chief={self._chief_address!r})")
