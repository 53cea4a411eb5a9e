"""Developer tooling that ships with the package (not imported by the
server at runtime): the ``cclint`` static-analysis pass lives here."""
