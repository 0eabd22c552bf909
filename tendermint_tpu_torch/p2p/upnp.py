"""UPnP IGD discovery, port mapping and external-IP probe: the port's copy
of `tendermint_tpu/p2p/upnp.py` (p2p/upnp: upnp.go Discover /
AddPortMapping / GetExternalIPAddress, probe.go:114 Probe), on stdlib
only: SSDP M-SEARCH over UDP multicast finds an Internet Gateway
Device, its description XML yields the WANIPConnection control URL, and
SOAP POSTs drive the service. `probe_upnp` (cli.py) runs the same
capability check the reference's probe does: get external IP, map a
port, verify, unmap.

Everything takes explicit timeouts and raises UPnPError on any failure;
the switch's listener (external-address detection when
`p2p.skip_upnp` is false) treats UPnP as best effort.
"""

from __future__ import annotations

import socket
import time
from typing import Optional
from urllib.parse import urljoin, urlparse
from urllib.request import Request, urlopen
from xml.etree import ElementTree

SSDP_ADDR = ("239.255.255.250", 1900)
ST_IGD = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"
_WAN_SERVICES = (
    "urn:schemas-upnp-org:service:WANIPConnection:1",
    "urn:schemas-upnp-org:service:WANPPPConnection:1",
)


class UPnPError(Exception):
    pass


class IGD:
    """A discovered Internet Gateway Device's WAN connection service."""

    def __init__(self, control_url: str, service_type: str,
                 local_ip: str):
        self.control_url = control_url
        self.service_type = service_type
        self.local_ip = local_ip

    # ------------------------------------------------------------- SOAP

    def _soap(self, action: str, args: dict, timeout: float = 5.0) -> dict:
        body = (
            '<?xml version="1.0"?>'
            '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"'
            ' s:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
            "<s:Body>"
            f'<u:{action} xmlns:u="{self.service_type}">'
            + "".join(f"<{k}>{v}</{k}>" for k, v in args.items())
            + f"</u:{action}></s:Body></s:Envelope>"
        ).encode()
        req = Request(self.control_url, data=body, headers={
            "Content-Type": 'text/xml; charset="utf-8"',
            "SOAPAction": f'"{self.service_type}#{action}"',
        })
        try:
            with urlopen(req, timeout=timeout) as resp:
                xml = resp.read()
        except Exception as e:
            raise UPnPError(f"SOAP {action} failed: {e}") from e
        out = {}
        try:
            for el in ElementTree.fromstring(xml).iter():
                tag = el.tag.rsplit("}", 1)[-1]
                out[tag] = el.text or ""
        except ElementTree.ParseError as e:
            raise UPnPError(f"bad SOAP response for {action}: {e}") from e
        return out

    # ---------------------------------------------------------- actions

    def external_ip(self, timeout: float = 5.0) -> str:
        out = self._soap("GetExternalIPAddress", {}, timeout)
        ip = out.get("NewExternalIPAddress", "")
        if not ip:
            raise UPnPError("no NewExternalIPAddress in response")
        return ip

    def add_port_mapping(self, external_port: int, internal_port: int,
                         protocol: str = "TCP",
                         description: str = "tendermint_tpu",
                         lease_s: int = 0, timeout: float = 5.0) -> None:
        self._soap("AddPortMapping", {
            "NewRemoteHost": "",
            "NewExternalPort": external_port,
            "NewProtocol": protocol,
            "NewInternalPort": internal_port,
            "NewInternalClient": self.local_ip,
            "NewEnabled": 1,
            "NewPortMappingDescription": description,
            "NewLeaseDuration": lease_s,
        }, timeout)

    def delete_port_mapping(self, external_port: int,
                            protocol: str = "TCP",
                            timeout: float = 5.0) -> None:
        self._soap("DeletePortMapping", {
            "NewRemoteHost": "",
            "NewExternalPort": external_port,
            "NewProtocol": protocol,
        }, timeout)


# ---------------------------------------------------------------- discovery

def _parse_ssdp_location(datagram: bytes) -> Optional[str]:
    for line in datagram.decode(errors="replace").split("\r\n"):
        k, _, v = line.partition(":")
        if k.strip().lower() == "location":
            return v.strip()
    return None


def _local_ip_toward(location: str) -> str:
    """The local interface IP that routes toward the gateway."""
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        probe.connect((urlparse(location).hostname or "8.8.8.8", 9))
        return probe.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        probe.close()


def discover(timeout: float = 3.0,
             ssdp_addr=SSDP_ADDR, local_ip: Optional[str] = None) -> IGD:
    """SSDP M-SEARCH for an IGD, then resolve its WAN control URL
    (upnp.go Discover)."""
    msg = ("M-SEARCH * HTTP/1.1\r\n"
           f"HOST: {ssdp_addr[0]}:{ssdp_addr[1]}\r\n"
           'MAN: "ssdp:discover"\r\n'
           "MX: 2\r\n"
           f"ST: {ST_IGD}\r\n\r\n").encode()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        try:
            sock.sendto(msg, ssdp_addr)
        except OSError as e:  # no route to multicast (airgapped hosts)
            raise UPnPError(f"SSDP send failed: {e}") from e
        # `timeout` is the TOTAL discover budget: every recvfrom is
        # clamped to the remaining deadline (unrelated SSDP chatter must
        # not extend the window) and the device-description fetch below
        # runs on whatever budget is left.
        deadline = time.monotonic() + timeout
        seen: set = set()
        last_err: Optional[Exception] = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            sock.settimeout(remaining)
            try:
                data, _ = sock.recvfrom(4096)
            except socket.timeout:
                break
            location = _parse_ssdp_location(data)
            if not location or location in seen:
                continue
            seen.add(location)
            # per-candidate local IP: on a multi-homed host a failing
            # first responder may sit on a different interface than the
            # real IGD, and the port mapping must advertise the address
            # that routes toward the device actually used
            ip = local_ip if local_ip is not None \
                else _local_ip_toward(location)
            # a non-IGD device may answer first (media servers commonly
            # reply regardless of ST): probe it, and on failure keep
            # reading until the deadline instead of giving up
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                return _device_from_location(location, ip, remaining)
            except UPnPError as e:
                last_err = e
        if last_err is not None:
            raise UPnPError(f"no usable IGD found: {last_err}")
        raise UPnPError("no IGD responded to SSDP search")
    finally:
        sock.close()


def _device_from_location(location: str, local_ip: str,
                          timeout: float) -> IGD:
    try:
        with urlopen(location, timeout=timeout) as resp:
            xml = resp.read()
    except Exception as e:
        raise UPnPError(f"cannot fetch device description: {e}") from e
    try:
        root = ElementTree.fromstring(xml)
    except ElementTree.ParseError as e:
        raise UPnPError(f"bad device description: {e}") from e
    # find a WAN*Connection service anywhere in the device tree
    for svc in root.iter():
        if not svc.tag.endswith("service"):
            continue
        st = ctl = ""
        for child in svc:
            tag = child.tag.rsplit("}", 1)[-1]
            if tag == "serviceType":
                st = (child.text or "").strip()
            elif tag == "controlURL":
                ctl = (child.text or "").strip()
        if st in _WAN_SERVICES and ctl:
            return IGD(urljoin(location, ctl), st, local_ip)
    raise UPnPError("device has no WANIPConnection service")


def probe(timeout: float = 3.0, ssdp_addr=SSDP_ADDR,
          test_port: int = 46656) -> dict:
    """The reference's capability probe (probe.go:114): discover, read
    the external IP, round-trip a port mapping. Returns a capability
    report dict; raises UPnPError when no IGD is reachable."""
    igd = discover(timeout=timeout, ssdp_addr=ssdp_addr)
    report = {"control_url": igd.control_url,
              "service_type": igd.service_type,
              "local_ip": igd.local_ip,
              "external_ip": None, "port_mapping": False}
    try:
        report["external_ip"] = igd.external_ip(timeout=timeout)
    except UPnPError:
        pass
    try:
        igd.add_port_mapping(test_port, test_port, lease_s=60,
                             timeout=timeout)
        igd.delete_port_mapping(test_port, timeout=timeout)
        report["port_mapping"] = True
    except UPnPError:
        pass
    return report


def external_address(timeout: float = 1.5) -> Optional[str]:
    """Best-effort external IP for listener advertisement
    (p2p/listener.go:51 GetUPNPExternalAddress): None when no IGD.

    `timeout` bounds the WHOLE operation: the GetExternalIPAddress SOAP
    call only gets what discover left of the budget, so listener startup
    stalls at most ~timeout, not a per-call multiple of it."""
    t0 = time.monotonic()
    try:
        igd = discover(timeout=timeout)
        remaining = timeout - (time.monotonic() - t0)
        if remaining <= 0:
            return None
        return igd.external_ip(timeout=remaining)
    except (UPnPError, OSError):
        return None
