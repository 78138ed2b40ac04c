"""The device's idle share over a cell's traced iterations or steps, in
%: what the host's dispatch leaves the card."""
from benchlib.readers import idle_percent as read  # noqa: F401
