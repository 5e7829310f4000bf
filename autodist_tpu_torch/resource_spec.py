"""Resource specification: the nodes and devices a run may use.

Counterpart of ``autodist_tpu/resource_spec.py`` for GPU hosts.  A spec is a
dict (or a YAML file of the same shape)::

    nodes:
      - address: 10.0.0.1
        gpus: [0, 1, 2, 3]      # "chips:" is an alias; "cpus:" lists CPUs
        chief: true
        ssh_config: conf        # optional, for the Cluster's remote launch
        network_bandwidth: 100  # Gbps (default 1, with a warning)
      - address: 10.0.0.2
        gpus: [0, 1, 2, 3]
    ssh:
      conf:
        username: root
        key_file: ~/.ssh/id_rsa
        port: 22
        python_venv: ''
        shared_envs: {}

Device strings read ``"<address>:GPU:<index>"``.  With no spec, the local
GPUs are detected through ``torch.cuda.device_count()``; with none and no
``device="cpu"`` request that raises.  ``yaml`` is imported only to read a
file.  :meth:`ResourceSpec.shrink` gives the surviving topology of a
membership change (the elastic trainer's).  Left for later (ROADMAP, Queue
A item 10, with the cost model that reads it): the ``topology:`` string.
"""
import os
from collections import OrderedDict, namedtuple
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


SSHConfig = namedtuple(
    "SSHConfig", ["username", "port", "python_venv", "key_file", "pythonpath", "env"])


def _parse_ssh_group(conf):
    return SSHConfig(username=conf.get("username", ""), port=int(conf.get("port", 22)),
                     python_venv=conf.get("python_venv", ""),
                     key_file=conf.get("key_file", ""), pythonpath=conf.get("pythonpath", ""),
                     env=dict(conf.get("shared_envs", {}) or {}))


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
        self._ssh_configs = {}
        self._bandwidths = {}
        self._explicit_bandwidths = {}   # only the entries the spec gives
        if resource_file is not None:
            if not os.path.exists(resource_file):
                raise ResourceSpecError(f"Resource spec {resource_file} does not exist")
            resource_info = _read_yaml(resource_file)
        if resource_info is None:
            resource_info = self._local_resource_info(device)
        self._from_resource_info(resource_info)
        self._validate()

    @classmethod
    def from_num_chips(cls, n, address="localhost"):
        return cls(resource_info={"nodes": [{"address": address, "gpus": list(range(n)),
                                             "chief": True}]})

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
        if info.get("topology"):
            raise NotImplementedError(
                "resource spec key 'topology': the ICI topology string feeds the cost "
                "model, a later slice of the port (ROADMAP, Queue A item 10)")
        for group, conf in (info.get("ssh") or {}).items():
            self._ssh_configs[group] = _parse_ssh_group(conf or {})
        self._mesh_request = info.get("mesh")
        nodes = info.get("nodes") or []
        if not nodes:
            raise ResourceSpecError("Resource spec has no nodes")
        for node in nodes:
            self._parse_node(node, len(nodes))

    def _parse_node(self, node, num_nodes):
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
        if "network_bandwidth" in node:
            self._bandwidths[address] = float(node["network_bandwidth"])
            self._explicit_bandwidths[address] = float(node["network_bandwidth"])
        else:
            if num_nodes > 1:
                logging.warning("Network bandwidth for node %s not specified; defaulting to "
                                "1 Gbps", address)
            self._bandwidths[address] = 1.0
        self._nodes[address] = {"address": address, "devices": devices,
                                "chief": is_chief, "ssh_config": node.get("ssh_config")}

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
    def num_cpus(self):
        return len(self.cpu_devices)

    def node_devices(self, address):
        return list(self._nodes[address]["devices"])

    def network_bandwidth(self, address):
        return self._bandwidths[address]

    @property
    def explicit_bandwidths(self):
        """Only the bandwidths the spec gives (no 1 Gbps default)."""
        return dict(self._explicit_bandwidths)

    def ssh_config(self, address):
        """The :class:`SSHConfig` of the node's ``ssh_config`` group, or
        None for a node without one."""
        group = self._nodes[address].get("ssh_config")
        if group is None:
            return None
        if group not in self._ssh_configs:
            raise ResourceSpecError(f"Unknown ssh group {group!r} for node {address}")
        return self._ssh_configs[group]

    @property
    def ssh_config_map(self):
        return dict(self._ssh_configs)

    @property
    def mesh_request(self):
        """Optional explicit {axis_name: size} mesh request."""
        return dict(self._mesh_request) if self._mesh_request else None

    @property
    def is_single_node(self):
        return len(self._nodes) == 1

    def shrink(self, drop_addresses=(), keep_chips=None):
        """A new spec of the SURVIVING topology after a membership change:
        ``drop_addresses`` removes whole nodes (a lost worker),
        ``keep_chips`` (``{address: [device, ...]}``) shrinks a node's
        device set in place (a degraded host; on one node, the elastic
        trainer's chaos kill).

        Chief failover is deterministic: when the chief is dropped, the
        first surviving node in spec order becomes chief (the successor
        :meth:`Cluster.successor_chief` names), so every process derives
        the same spec.  The ``mesh:`` request is not carried over (it was
        sized for the old device count); the ssh groups and the explicit
        bandwidths are.
        """
        drop = set(drop_addresses)
        keep_chips = dict(keep_chips or {})
        unknown = (drop | set(keep_chips)) - set(self._nodes)
        if unknown:
            raise ResourceSpecError(f"shrink: unknown node address(es) {sorted(unknown)}; "
                                    f"spec has {list(self._nodes)}")
        survivors = [a for a in self._nodes if a not in drop]
        if not survivors:
            raise ResourceSpecError("shrink would drop every node")
        chief = self._chief_address if self._chief_address in survivors else survivors[0]
        nodes = []
        for addr in survivors:
            node = self._nodes[addr]
            accel = [d.device_index for d in node["devices"] if d.device_type != DeviceType.CPU]
            cpus = [d.device_index for d in node["devices"] if d.device_type == DeviceType.CPU]
            if addr in keep_chips:
                kept = list(keep_chips[addr])
                bad = set(kept) - set(accel or cpus)
                if bad:
                    raise ResourceSpecError(f"shrink: node {addr} has no chip(s) {sorted(bad)}")
                if accel:
                    accel = [i for i in accel if i in kept]
                else:
                    cpus = [i for i in cpus if i in kept]
                if not accel and not cpus:
                    continue   # the node shrank to nothing: drop it
            entry = {"address": addr, "chief": addr == chief}
            if accel:
                entry["gpus"] = accel
            if cpus and not accel:
                entry["cpus"] = cpus
            if node.get("ssh_config") is not None:
                entry["ssh_config"] = node["ssh_config"]
            if addr in self._explicit_bandwidths:
                entry["network_bandwidth"] = self._explicit_bandwidths[addr]
            nodes.append(entry)
        if not nodes:
            raise ResourceSpecError("shrink would drop every device")
        if not any(n["chief"] for n in nodes):
            nodes[0]["chief"] = True   # the chief's node lost all its devices
        info = {"nodes": nodes}
        if self._ssh_configs:
            info["ssh"] = {g: {"username": c.username, "port": c.port,
                               "python_venv": c.python_venv, "key_file": c.key_file,
                               "pythonpath": c.pythonpath, "shared_envs": dict(c.env)}
                           for g, c in self._ssh_configs.items()}
        return ResourceSpec(resource_info=info)

    def __repr__(self):
        return (f"ResourceSpec(nodes={len(self._nodes)}, "
                f"accelerators={self.num_accelerators}, chief={self._chief_address!r})")
