"""One test body for both packages (no tests here).

The twin files (``tests/test_torch_{loadgen,experiment_loop,kube_mode,
install}.py``) run the scenarios of the reference's own tests through one
parametrised body: a test takes the ``pkg`` fixture, which points the
file's ``Twin`` at ``datatunerx_tpu`` or ``datatunerx_tpu_torch``, and
reaches every name of the package under test through it (``M.Name``,
``M.mod("sub.module")``)."""

import importlib

PKGS = ("datatunerx_tpu", "datatunerx_tpu_torch")


class Twin:
    """Names of the package in use: ``Twin(Name="sub.module:attr")``
    resolves ``M.Name`` to ``<pkg>.sub.module.attr`` at each access."""

    def __init__(self, **names):
        self.pkg = PKGS[0]
        self.names = names

    def use(self, pkg: str) -> str:
        self.pkg = pkg
        return pkg

    def mod(self, name: str):
        return importlib.import_module(f"{self.pkg}.{name}")

    def __getattr__(self, name):
        if name.startswith("_") or name not in self.__dict__.get("names", {}):
            raise AttributeError(name)
        module, _, attr = self.names[name].partition(":")
        return getattr(self.mod(module), attr)
