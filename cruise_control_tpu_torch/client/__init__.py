"""Python CLI client (upstream ``cruise-control-client`` / ``cccli``)."""

from cruise_control_tpu_torch.client.cccli import CruiseControlClient, main

__all__ = ["CruiseControlClient", "main"]
