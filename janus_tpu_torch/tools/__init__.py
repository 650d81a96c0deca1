"""Operator CLIs (reference tools/src/bin/): collect, dap_decode,
hpke_keygen, gen_alert_rules (Prometheus rules from the in-process SLO
definitions), debug_bundle (incident snapshot of a health listener),
report_trace ("where did report X go" — one report joined across the
upload journal, every datastore table, and the conservation ledger),
scrape_check (the deploy smoke check of a health listener) and
chaos_run (the crash-storm and datastore-outage schedules against the
real job driver binary). Invoke as
`python -m janus_tpu_torch.tools.<name>`."""
