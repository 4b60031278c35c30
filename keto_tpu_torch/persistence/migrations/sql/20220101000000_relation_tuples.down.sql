DROP TABLE keto_relation_tuples;
