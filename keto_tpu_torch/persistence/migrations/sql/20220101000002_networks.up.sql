-- Network registry (reference networkx: the server determines its network id
-- from the database at boot, registry_default.go:207-225). A store opened
-- without an explicit network id adopts the oldest row, creating one first
-- if the database is fresh — so a restarted server sees its own data.
CREATE TABLE keto_networks (
    id TEXT PRIMARY KEY,
    created_at REAL NOT NULL
);
