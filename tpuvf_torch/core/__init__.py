"""Framework-neutral core: formats, specs, properties, elements, frames."""
