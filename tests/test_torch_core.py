"""The port's control plane (``src/repro_torch/core``) is the reference's
(``src/repro/core``), copied: every module, and the bridge
``serving/host.py``, equals the reference's once ``repro.`` is read as
``repro_torch.`` (docstring cross-references), so the reference's own
control-plane tests vouch for the copy. The one other difference is two
``# vclint: disable=VCL002`` lines: the repo's lint gate
(``tests/test_vclint.py::test_repo_src_is_clean``) reads all of ``src``
against a baseline keyed by path, which accepts these two findings for
``src/repro/core``; the copy carries the same acceptances inline. A
quickstart scenario then runs on both packages and must leave the same
super-cluster namespaces, unit names and tenant-visible phases."""
import importlib
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF_CORE = REPO / "src" / "repro" / "core"
PORT_CORE = REPO / "src" / "repro_torch" / "core"
CORE_MODULES = sorted(p.name for p in REF_CORE.glob("*.py"))
# the reference's baselined lint findings, accepted inline in the copy
PRAGMAS = {"informer.py": 1, "router.py": 1}


def _as_port(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


def _without_pragmas(text: str):
    """``text`` without its lines that hold only a vclint pragma, and how
    many there were."""
    lines = text.splitlines(keepends=True)
    kept = [line for line in lines
            if not line.strip().startswith("# vclint: disable=")]
    return "".join(kept), len(lines) - len(kept)


def test_every_core_module_is_copied():
    assert len(CORE_MODULES) == 24
    assert sorted(p.name for p in PORT_CORE.glob("*.py")) == CORE_MODULES


@pytest.mark.parametrize("module", CORE_MODULES)
def test_core_module_equals_reference(module):
    port, pragmas = _without_pragmas((PORT_CORE / module).read_text())
    assert port == _as_port((REF_CORE / module).read_text())
    assert pragmas == PRAGMAS.get(module, 0)


def test_host_equals_reference():
    ref = REPO / "src" / "repro" / "serving" / "host.py"
    port = REPO / "src" / "repro_torch" / "serving" / "host.py"
    assert port.read_text() == _as_port(ref.read_text())


def _quickstart(core):
    """Two tenants with identical unit names on a shared super cluster
    (``examples/quickstart.py``'s first half). The namespace prefix holds a
    hash of the tenant object's random UID, so namespaces are given with
    the prefix ``ns_prefix`` computes replaced by ``<tenant>-<hash>``."""
    fw = core.VirtualClusterFramework(num_nodes=4, scan_interval=0.0,
                                      heartbeat_interval=3600)
    with fw:
        planes = [fw.add_tenant("acme", weight=2),
                  fw.add_tenant("globex", weight=1)]
        for plane in planes:
            for name in ("train-job", "eval-job"):
                fw.submit(plane, fw.make_unit(name, "default", chips=2))
        for plane in planes:
            fw.wait_all_ready(plane, "default", 2, timeout=30)
        prefixes = {core.ns_prefix(vc.metadata.name, vc.metadata.uid):
                    f"{vc.metadata.name}-<hash>"
                    for vc in fw.super_api.list("VirtualClusterCR")}

        def generic(ns):
            for prefix, name in prefixes.items():
                if ns.startswith(prefix + "-"):
                    return name + ns[len(prefix):]
            return ns

        super_units = sorted(
            (generic(u.metadata.namespace), u.metadata.name, u.status.phase)
            for u in fw.super_api.list("WorkUnit"))
        tenant_units = {
            plane.name: sorted((u.metadata.name, u.status.phase)
                               for u in plane.api.list("WorkUnit",
                                                       "default"))
            for plane in planes}
        namespaces = sorted(generic(n.metadata.name)
                            for n in fw.super_api.list("Namespace"))
    return namespaces, super_units, tenant_units


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_quickstart_scenario(package):
    namespaces, super_units, tenant_units = _quickstart(
        importlib.import_module(f"{package}.core"))
    assert namespaces == ["acme-<hash>-default", "globex-<hash>-default"]
    assert super_units == [
        (f"{t}-<hash>-default", name, "Ready")
        for t in ("acme", "globex") for name in ("eval-job", "train-job")]
    assert tenant_units == {
        t: [("eval-job", "Ready"), ("train-job", "Ready")]
        for t in ("acme", "globex")}
