"""One-device training: the train step and the fault-tolerant loop
(twin of ``repro/train``)."""
