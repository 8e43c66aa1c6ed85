"""Applications built on the query layer (port of ``spatialflink_tpu.apps``;
reference: ``GeoFlink/apps/``): stay time per grid cell and room
occupancy from check-in events. Host-only: neither app launches a
kernel."""

from spatialflink_tpu_torch.apps.check_in import CheckIn, parse_checkin_csv
from spatialflink_tpu_torch.apps.stay_time import StayTime

__all__ = ["StayTime", "CheckIn", "parse_checkin_csv"]
