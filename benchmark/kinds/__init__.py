"""Traffic kinds: kinds/<kind>.py runs a mix whose "kind" names it."""
