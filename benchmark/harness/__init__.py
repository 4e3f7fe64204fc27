"""The benchmark's harness: what a cell needs found by name
(:mod:`.spec`), its traffic (:mod:`.traffic`), the timed window over the
program's bank (:mod:`.window`), the device trace (:mod:`.devtrace`), the
rooflines' arithmetic (:mod:`.roofline`) and the comparison that decides
``correct`` (:mod:`.check`)."""
