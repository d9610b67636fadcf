"""The benchmark's own tests: a package, so that its ``conftest`` is
imported under its own name beside the repository's ``tests/conftest``."""
