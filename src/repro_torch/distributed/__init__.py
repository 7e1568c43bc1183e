"""The mesh layer's rules, the counterpart of ``repro/distributed``:
int8 error-feedback gradient compression (:mod:`.compression`) and the
rules that map every parameter, batch, cache and optimizer-state
dimension onto a mesh (:mod:`.sharding`)."""
