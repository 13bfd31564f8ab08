"""The runtime layer of the port: deterministic fault injection
(:mod:`.faults`) and the replicate retry, quarantine and artifact
validation policy (:mod:`.resilience`)."""
