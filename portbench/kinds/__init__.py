"""The kinds of traffic, one module each, found by a traffic file's ``kind``
(``harness.load_kind``)."""
